"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. card -- ``nvidia-smi`` name and power limit, ``torch.cuda`` device
   name; TF32 turned off for matmuls and cuDNN.
2. build -- every CUDA source in ``horovod_tpu_torch/ops/csrc`` compiled
   with ``nvcc`` for ``sm_90a``, one process per source, all at once;
   the registers and spill stack of the bf16 tensor-core kernels.
3. kernels -- each kernel against its plain PyTorch version on the card
   at its path's shapes (serving: flash forward and decode, the decode at
   lengths either side of a page and of a split, timed as device time by
   replaying a CUDA graph, as is its SDPA yardstick; training: the flash
   backward's dq and dk/dv -- the forward, dq and dk/dv run on the
   tensor cores in bf16 and on the CUDA cores in f32; cases from 37 to
   2048 tokens, a ragged 1000, tq < tk, segments with dead rows and
   keys, head dims 128 and 64, and two launches bitwise equal, with the
   TFLOP/s of the headline case; ResNet and Inception: the BatchNorm
   backward's two passes, at a ragged N, a C below one vector, three
   ResNet-50 sites at batch 256 and four Inception-v3 sites at batch 32,
   bitwise repeatable, timed from a replayed CUDA graph at ResNet's
   headline site and at Inception's most rows and widest channels, as is
   their ``native_batch_norm_backward`` yardstick; PowerSGD: the three
   ``fused_update`` stages at both ResNet-50 bucket shapes, r = 1 and
   4, with and without a residual, Average and Sum with a postscale,
   bitwise repeatable, timed from a replayed CUDA graph), with its time,
   the plain version's time, one
   PyTorch library call's time for the same function where one exists,
   and the least time the card could take (``bound_ms``).  BERT: the
   forward, dq and dk/dv at BERT-Large's heads (16 of 64, bidirectional)
   at 64 x 128 tokens and at 4 x 512 packed with two segments a row,
   against their plain versions, and -- on a line of their own -- their
   times beside SDPA's and their bounds.
4. serve -- Llama-3 8B at full width and depth (random bf16 weights from
   a seed) serves 8 requests through ``ServingEngine``; the kernels'
   launch counters must show the main path went through them, and the
   first request's first-token logits must match the same prefill run
   through the plain attention.
5. grad -- Llama-3 8B at full width, 2 layers, LoRA rank 8 with non-zero
   adapters: one loss and backward through the kernels against the same
   through the plain attention (loss within 1e-2 relative, every LoRA
   gradient within 2e-2 of its max |value|).
6. train -- Llama-3 8B at full width and depth, frozen bf16 base, LoRA
   rank 8 on all seven projections: ``init`` (world 1, NCCL) ->
   ``broadcast_parameters`` -> ``DistributedOptimizer(AdamW,
   compression=bf16)`` -> ``make_train_step``, one warm-up and five timed
   steps on a 2 x 2048-token batch.  The loss must stay finite and fall,
   every adapter change, every base tensor stay bitwise the same, each
   step launch 32 flash forwards and 32 of each backward kernel, and the
   optimizer send as many buckets per step as ``plan_buckets`` plans.
7. resnet_grad -- ResNet-50 at full width and depth (s2d stem, every BN
   scale from N(1, 0.1)) on 32 images: one loss and backward through the
   BN kernels and one through their plain versions, in bf16 and in f32
   from the same weights.  Losses bitwise equal; 53 launches of each BN
   kernel, 0 on the plain runs; f32 gradients within 1e-3 of their max;
   no bf16 gradient moved by the kernels as much as bf16 moves it from
   f32 (see ``check_resnet_grad``).
8. resnet_train -- ``bench.py``'s ResNet-50 configuration: 256 images of
   224 x 224, bf16 compute, ``init`` -> ``broadcast_parameters`` ->
   ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` ->
   ``make_flax_train_step``, one warm-up and five timed steps.  Losses
   finite and falling, every parameter and running statistic changed,
   53 launches of each BN kernel a step, buckets as planned.
9. resnet_powersgd -- the same with ``compression="powersgd:4"``
   (``bench.py``'s ``HOROVOD_COMPRESSION=powersgd:4`` variant): the
   rank-4 PowerSGD exchange with its error-feedback residuals, each
   bucket through the three ``fused_update`` kernels and two factor
   allreduces.  One warm-up step, whose two real buckets are exchanged
   again through the plain versions (out and new residual within 1e-4 of
   their max), and five timed steps: losses finite and falling, 161 of
   161 parameters changed, residuals finite and non-zero, 2 buckets, 4
   handles and 227,888 wire bytes a step, 10 launches of each stage.
10. lenet -- ten LeNet steps on a synthetic MNIST-like batch with
   ``examples/mnist_lenet.py``'s SGD(0.01, momentum 0.9); the loss falls.
11. bert_grad -- BERT at BERT-Large's width, 2 layers, bf16, on 4 x 512
   tokens packed with two segments a row: one loss and backward through
   the attention kernels against the same through the plain attention
   (loss within 1e-2 relative, every gradient within 2e-2 of its max
   |value| -- ``wk.bias``'s, zero in exact arithmetic, of its layer's
   ``wk.kernel`` gradient's), 2 launches of each kernel, none on the
   plain run; both runs against the model in f32 as information.
12. bert_train -- BERT-Large at full width and depth
   (``examples/bert_pretrain.py --large``), bf16 compute: ``init`` ->
   ``broadcast_parameters`` -> ``DistributedAdasumOptimizer(AdamW,
   compression=fp16)`` -> ``make_train_step(bert_pretrain_loss)``, one
   warm-up and five timed steps on 64 x 128 tokens, then four more.
   Losses finite and the last below the first (AdamW at lr 1e-3 with no
   learning-rate warm-up first drives the loss up; the same ten steps
   through the plain attention are logged beside them), all 399 tensors
   changed, 24 launches of each attention kernel a timed step, the
   buckets of the flax-ordered plan with 672,395,268 fp16 wire bytes a
   step, and the warm-up step's every reduced bucket bitwise the fp16
   round trip of its packed gradient (Adasum over one rank is the
   identity).
13. bn_sync -- synchronized BatchNorm at world 1 (5 warm-up and 20
   timed steps each): ``sync_batch_norm`` against the plain
   ``ops.bn.BatchNorm`` at ResNet-50's ``[256, 56, 56, 256]`` and
   Inception's ``[32, 147, 147, 32]`` bf16 -- output, running
   statistics, dx, dgamma and dbeta bitwise equal (the allreduces of one
   rank are identities), both within phase 3's BN bounds of the backward
   through the plain versions, one launch of each BN kernel and two
   allreduces a step; ``hvd.SyncBatchNorm`` on channels_last bf16 ``[32,
   64, 147, 147]`` against autograd of the f32 formula, with no layout
   copy, timed beside cuDNN's ``BatchNorm2d``; ``bn_backward_dx`` with
   ``count`` four times its rows against its plain version.
14. inception_train -- Inception-v3 through the synthetic benchmark's own
   setup (``python -m horovod_tpu_torch.synthetic_benchmark --model
   inception_v3``: 32 images of 299 x 299, bf16, 1000 classes,
   ``DistributedOptimizer(SGD(0.01, momentum 0.9))``), one warm-up and
   five timed steps: losses finite and falling, every parameter and
   running statistic changed, 94 launches of each BN kernel a step,
   buckets and handles as planned, 4 wire bytes a parameter.
15. vgg_train -- VGG-16 the same way at 224 x 224: 553,430,176 wire
   bytes a step (138,357,544 f32 gradients, one tensor of 411 MB), the
   planned buckets, and no kernel launch (the classic VGG has no BN).
16. fused_update_launches -- each PowerSGD stage launch's own device
   time at the headline case, from ``torch.profiler`` (information).
17. torch_api -- the ``horovod.torch`` surface on NCCL at world 1, on the
   global set and on a one-member ``add_process_set([0])``: reducescatter
   (every op, dims 0 and 1), alltoall even and with ``splits``, the
   grouped allgather and reducescatter, ``sparse_allreduce_async``,
   ``allgather_object``, process-set and hierarchical Adasum, integer
   handles through ``synchronize`` and ``poll``, each held exactly to its
   definition (at world 1 an identity or a slice); then each op's ms on a
   64 MiB f32 buffer.
18. torch_mnist -- ``python -m horovod_tpu_torch.examples.pytorch_mnist``'s
   ``main()`` (the stock Horovod script, fp16 compression) for 30 steps:
   the losses, the last below 0.7 of the first, the step ms.
19. torch_resnet50 -- ``horovod_tpu_torch.examples.torch_resnet50`` at
   full width: 256 images of 224 x 224, NCHW module code run
   channels_last under bf16 autocast, 53 ``hvd.SyncBatchNorm(
   process_set=ps)`` sites on the BN kernels, ``DistributedOptimizer(
   SGD(0.1, momentum 0.9), compression=fp16, process_set=ps)``; one
   warm-up and five timed steps: losses finite and falling, every
   parameter changed, 53 launches of each BN kernel and 106 sync-BN
   allreduces a step, the planned buckets with 51,114,064 wire bytes a
   step, and the layout copies a step (expected 0).
20. resnet_exchange -- phase 8's ResNet-50 (256 x 224 x 224, bf16, seed
   0) through three exchanges, one warm-up and five timed steps each,
   the model reset and only the optimizer rebuilt between them: (a)
   ``zero_stage=1`` with the bare ``SGD(0.1, momentum 0.9)`` (``bench.py``'s
   ``batch256_s2d_bf16_zero1``): ZeRO-1 bytes a step equal to
   ``zero_report``'s, and parameters within 1e-6 of max |param| of plain
   SGD's after six steps from the same weights on the same batch
   (deterministic cuDNN in both runs; bitwise equality recorded); (b)
   ``DistributedOptimizer(SGD, compression=Compression.fp8)``: the first
   step's every bucket bitwise its fp8 round trip, one wire byte a value;
   (c) ``topk:0.25`` with error feedback: ``own + new_residual == acc``
   bitwise for every bucket on every step, the residual zero at the k
   sent indices and ``acc`` at the rest, ``8k / 2`` wire bytes a bucket.
   Each: step ms, images/s, peak memory, buckets, handles and wire bytes a
   step, 53 launches of each BN kernel a step, five finite losses.
21. resnet_loop -- phase 8's ResNet-50 with deterministic cuDNN through
   (a) ``make_flax_train_loop(steps_per_execution=4)`` fed by
   ``DevicePrefetcher(depth=2, stack_steps=4)``: three windows (eager,
   captured as one CUDA graph and replayed, replayed) bitwise equal to
   twelve ``make_flax_train_step`` calls (parameters, BN statistics,
   momentum buffers, losses), 53 + 53 BN launches and phase 8's exchange
   a step counted over replays; (b) ``make_flax_train_step(
   microbatches=4)``: 4 x 53 launches of each BN kernel, four ``mb_rs``
   rows and one ``mb_ag`` row a bucket as ``plan_exchange("microbatch")``
   gives them, losses finite and falling; (c) the loop of (b)'s step,
   bitwise (b)'s twelve steps; (d) Inception-v3 (phase 14's cell, dropout
   0.5 from a generator registered with the graph) through the loop,
   bitwise its eager steps.  Each: step ms, images/s, peak memory and the
   host ms to dispatch a window beside the eager steps', and the
   ResNet-50 buckets' ``render_plan``.
22. elastic_resnet -- Elastic Horovod (BASELINE's fifth configuration)
   on the card: (a) the launcher, ``python -m horovod_tpu_torch.run
   --host-discovery-script <one host, one slot> --min-np 1 --max-np 1``
   running ``horovod_tpu_torch.examples.elastic_train`` with
   ``ELASTIC_MODEL=resnet50`` at 224 x 224 for 8 batches, once over the
   assignment file and once with ``--network-rendezvous`` under
   ``HOROVOD_CHAOS`` (a 2 s KV blackout, a 1 s heartbeat drop, a 30 s
   heartbeat timeout): each exits 0 at "final size 1"; the wall seconds,
   the worker's step ms after the first and the KV retries the blackout
   cost; (b) phase 8's ResNet-50 (256 x 224 x 224, bf16, deterministic
   cuDNN) in ``@hvd.elastic.run`` with a ``TorchState`` committing every
   2 steps, 12 steps uninterrupted and again with
   ``chaos.install("seed=7;comm@step=5,rank=0")``: the fault rolls back
   a commit, ``hvd.shutdown()`` / ``hvd.init()`` build a new NCCL
   communicator in the process and the step is rebuilt; parameters, BN
   statistics, momentum and the last 8 losses bitwise the uninterrupted
   run's; then the same through ``make_flax_train_loop(
   steps_per_execution=4)`` (one loop object across the re-init: it
   drops its graph and captures again), bitwise the eager run.  Logged:
   ``horovod_elastic_steps_to_recover``, the restore, re-init and first
   step after it (ms), commit ms (median), step ms beside phase 8's,
   peak GB and the BN launches.
23. sdc_resnet -- the silent-data-corruption and observability planes on
   phase 8's cell (deterministic cuDNN) under ``HOROVOD_GUARD=1``,
   ``HOROVOD_GUARD_STREAK=3``, ``HOROVOD_SNAPSHOT_STEPS=2``,
   ``HOROVOD_CHECK_DESYNC=1``, ``HOROVOD_DESYNC_CHECK_STEPS=2``, a
   ``HOROVOD_TIMELINE`` file and ``HOROVOD_METRICS_PORT=0``: (a) 12
   guarded ``make_flax_train_step`` steps bitwise 12 unguarded ones
   (parameters, momentum, BN statistics, losses), no skip, the ms a step
   of each; (b) under ``@hvd.elastic.run`` (a commit every 2 steps) a
   ``nan@`` chaos fault wedges the input from step 7: steps 7, 8 and 9
   are skipped with the state bitwise that before each, the third skip
   raises ``SustainedAnomalyError``, the ledger rolls back to step 6 and
   the replay ends bitwise the uninterrupted run; (c) the same through
   ``make_flax_train_loop(steps_per_execution=4)``: the guard inside the
   CUDA graph, the windows' ``[4, 3]`` rows to the policy, six skips, a
   rollback to step 4, the graph replayed after it, bitwise (b); (d) the
   timeline file as JSON with a dispatch event a step call and the
   ``host_dispatch_gap`` track, the merge CLI on it, ``/metrics`` from
   the ``MetricsServer`` holding the guard, tripwire, step and straggler
   families, and the ms of a commit with and without the desync check
   and tripwire, of one ``check_desync`` and of one tripwire check (at
   world 1 the tripwire sees one value and can name no rank).  Logged:
   ``horovod_guard_skipped_total``, ``horovod_guard_rollbacks_total``,
   the steps to recover and the recovery ms, the BN launches.
24. autotune_resnet -- the autotuner, the launcher's probe and LSF
   ``-np``, and the sharded checkpoints on phase 8's cell (deterministic
   cuDNN) under ``HOROVOD_AUTOTUNE=1``, ``HOROVOD_AUTOTUNE_CHUNK=1`` and
   a ``HOROVOD_AUTOTUNE_LOG`` file; ``init()`` must build the tuner,
   which the phase replaces with ``Autotuner(cfg, steps_per_sample=3,
   max_samples=6)``.  (a) ``make_flax_train_step`` until the tuner locks
   (a sample: one unscored step and three scored), then three steps at
   the chosen threshold and chunk: every step's buckets as
   ``plan_buckets`` plans them at its sample's threshold, the run
   bitwise as many untuned steps (parameters, momentum, BN statistics,
   losses), six samples in the log and its ``# best`` row; (b) the same
   through ``make_flax_train_loop(steps_per_execution=4)`` with four
   samples: each sample one eager window, one capture and three scored
   replays, so one capture a trace key and no eager or capture window
   scored, bitwise as many untuned windows; (c) a second tuner over
   (a)'s log is done at construction with (a)'s best; (d)
   ``save_checkpoint_sharded`` / ``restore_checkpoint_sharded`` of the
   parameters, BN statistics and momentum (205 MB) bitwise, on the card,
   beside ``save_checkpoint`` / ``restore_checkpoint``; (e) ``python -m
   horovod_tpu_torch.run --probe --autotune`` under ``LSB_JOBID`` and
   ``LSB_MCPU_HOSTS="<this host> 1"`` with no ``-np``: exit 0, the probe
   report, a worker on ``cuda`` at size 1 with a tuner.  Logged: the
   samples' scores (bytes/s) by threshold and chunk, the chosen pair,
   the step ms at it beside the default 64 MiB, the tuning steps' ms,
   ``horovod_autotune_samples_total``, the captures of (b), each
   checkpoint call's ms, the BN launches.
25. eager_join -- the eager control plane on phase 19's cell (the
   torch-idiom ResNet-50, deterministic cuDNN).  (a) The batched
   ``DistributedOptimizer`` (``HVD_TPU_NATIVE_CORE=1``: the hooks hand
   each gradient to the native cycle scheduler, 1 ms, deterministic, one
   ``grouped_allreduce`` a cut batch): one warm-up and five timed steps,
   then three more; the same six steps from the same weights on the
   planned buckets.  Losses and parameters bitwise equal (at world 1 an
   allreduce is a copy and the fp16 cast is per element), 53 launches
   of each BN kernel a step; both step times and the native batches cut
   a step are logged.  (b) The eager ops on the card at world 1:
   ``allreduce_async`` over the model's 161 gradient shapes and
   ``synchronize`` on each, immediate and -- through the tests'
   ``_defer_applies`` seam -- as one fused deferred flush; ``allgatherv``;
   ``alltoallv`` with splits; ``local_result``; ``local_rank_count() ==
   1``; ``join() == -1``; each held exactly, with
   ``deferred_fuse_stats()``.  (c) ``HOROVOD_AUTOTUNE=1`` on the batched
   path: three samples of 1 + 2 steps; the batcher is deterministic, so
   the cycle axis stays pinned to the configured 1 ms; the batcher holds
   each sample's threshold and that cycle time, and the nine tuned
   steps are bitwise (a)'s nine untuned ones.  (d) ``python -m
   horovod_tpu_torch.run -np 2 --cpu python -m
   horovod_tpu_torch.examples.join_check`` (gloo on this host): exit 0
   and ``join OK last=1`` from each rank.  Logged: the BN launches.

26. lora_int8_serve -- the int8 frozen base, remat, LoRA banks and
   speculative decoding at Llama-3 8B width (``examples/llama_lora.py``'s
   two modes).  (a) 2 layers, int8 base, rank-8 adapters with non-zero
   ``lora_b``: loss and LoRA gradients through the kernels against the
   plain attention within phase 5's bounds, and the same step with
   ``remat=True`` bitwise the step without (2 flash forwards more).
   (b) Full depth, int8 base + remat: phase 6's ``init`` ->
   ``broadcast_parameters`` (int8 tensors included) ->
   ``DistributedOptimizer(AdamW, bf16)`` -> ``make_train_step``, one
   warm-up and five timed steps at 2 x 2048, with phase 6's checks (every
   int8 ``q``/``scale`` bitwise unchanged) and 64 flash forwards and 32
   of each backward kernel a step; then the same from the same weights
   without remat (32 forwards); step ms and peak memory beside phase 6's
   bf16 base.  (c) Full depth, bf16 base, three adapters from seeds
   stacked with ``stack_adapters``: one engine serves six requests, the
   adapter ids cycling; each stream bitwise the stream of an engine
   serving that adapter from the tree (as many slots), the first-token
   logits within 1e-4 of max |logit| of the ``merge_lora`` weights'
   prefill in f32 compute (the bf16 pair logged against 2e-2), 32 flash launches a
   prefill and 32 decode launches a step.  (d) Phase 4's cell twice more,
   speculating (``spec_k=4``) with the n-gram drafter and with a
   ``ModelDrafter`` over the target's own weights: both streams equal
   phase 4's token for token, 32 decode launches a plain step, 5 x 32 a
   verify round and 32 a drafter step, the model drafter's every draft
   accepted; acceptance, tokens/s and token latency beside phase 4's.
27. serving_rest -- the rest of the serving plane at Llama-3 8B width
   and depth (phase 4's weights).  (a) ``long_prompt_spec(8, seed=1)``
   (512 to 4096 tokens) whole and with ``prefill_chunk=512``: the last
   chunk's logits within ``BF16_TOL`` of the whole 4096-token prompt's;
   flash launches 32 x prefill forwards, decode 32 x steps; streams,
   TTFT p50/p99 and tokens/s of both.  (b) One decode step over phase 4's
   prompts with every cold page compressed, bitwise the plain step over
   a pool holding the dequantised rows; then phase 4's load on a
   ``kv_compress`` engine that compresses cold pages before each step
   (32 launches of the e4m3 variant a step, the pool clean after).
   (c) ``prefix_spec`` (2 prefixes of 1024, 16 requests) with the cache
   on and off at ``prefill_chunk=512``: hits, FLOPs avoided, no page left
   after ``drop_all()``.  (d) One ``PrefillWorker`` and one
   ``DecodeWorker`` over a loopback ``RendezvousServer`` against a
   colocated engine: the f32 wire's streams bitwise, every handoff
   streamed, bytes in equal bytes out, no page leaked; the fp8 wire on a
   ``kv_compress`` engine, its pages bitwise ``demote_page``'s.
   Phase 3 holds the flash forward at tq 512 x tk 4096 and the decode
   kernel's e4m3 variant at 8 slots x 2048 keys (half the pages
   compressed) bitwise the plain kernel over the dequantised pool, at
   page 16 (timed) and at page 8 (every 16-key tile mixing e4m3 and
   bf16 rows), with the split kernel's registers, shared memory and
   CTAs an SM beside its uncompressed twin's.

28. parallel_3d -- the 3-D step (``examples/bert_pretrain.py --tp``) and
   sequence parallelism (``examples/long_context.py``).  (a) Phase 12's
   BERT-Large cell (64 x 128 tokens, bf16, 24 layers, 16 heads of 64)
   at world 1 on NCCL through ``build_3d_mesh(data=1, model=1)``,
   ``models.BertTP`` (``bert_tp_apply``), ``make_train_step(tp=1,
   param_specs=tp_param_specs(...))`` and ``DistributedOptimizer(AdamW,
   process_set=<data set>)``: one loss and backward against the port's
   ``Bert`` on the same weights and batch, in f32 (loss and every
   gradient within ``PAR_F32_GRAD_TOL`` of its max |value|: roundoff)
   and in bf16 (loss within 1e-2 relative; each gradient within
   ``BF16_TOL`` of the f32 reference's max, or -- as phase 7 reasons for
   a deep bf16 backward -- within twice ``Bert``'s own bf16 distance
   from f32 where that is larger; ``wk.bias`` at its layer's
   ``wk.kernel``'s scale; the bf16-against-bf16 distance is logged),
   24 launches of each attention kernel a pass; a warm-up and five
   timed bf16 steps (24 launches each a step), the step ms beside phase
   12's.
   (b) tp = 2 on the one card: this script run twice with
   ``--tp-worker`` -- two ranks on ``cuda:0`` that open a gloo group
   themselves (NCCL refuses two ranks on one GPU) before ``hvd.init(
   device="cuda:0")``, which keeps it -- one loss and backward of the
   same cell on ``build_3d_mesh(data=1, model=2)`` (8 local heads, 2,048
   FFN columns a rank), in f32 and in bf16, the gradients gathered over
   the model set into the full tree within (a)'s bounds of (a)'s, the
   bf16 ones against (a)'s floor, 24 launches of each
   attention kernel a rank, half of (a)'s bytes of split leaves a rank,
   then one step with 96 tensor-parallel allreduces (two forward and two
   backward a layer); the backend and the step ms logged.  Two faults
   the bf16 gate must reject, scored beside it: a third bf16 backward
   with Megatron's "f" (``copy_to_tp``) an identity, so the norm and
   embedding gradients stay each rank's partial, and the gathered bf16
   gradients with rank 1's half of every split leaf zeroed (a dropped
   shard).  (c) At world 1: ``long_context`` at sp 1, 4,096 tokens,
   head dim 64, five steps in ``--mode ulysses`` (5 launches of each
   attention kernel) and in ``--mode ring`` (plain PyTorch), each with
   ``--compare-single-device`` (its first loss within 5e-4 of
   ``attention_reference``'s), both falling, the first losses within
   2e-2; ``ulysses_attention`` (the flash kernels) and ``ring_attention``
   against ``attention_reference`` on the same f32 q/k/v at that shape
   (2 x 4 heads x 4,096 x 64, causal, without and with two packed
   segments): outputs within ``F32_TOL`` and dq/dk/dv within
   ``F32_GRAD_TOL`` of the reference's max |value| (the loss alone
   cannot see attention: the next token is random);
   ``sync_batch_norm(axes=("data",))`` at phase 13's first shape bitwise
   the plain layer, one launch of each BN kernel.

29. serving_tp -- Llama-3 8B (full width and depth, bf16, seed 0) at
   tp 2: this script run twice with ``--tp-worker serving_tp`` as two
   ranks on ``cuda:0`` over gloo, as phase 28 (b), each holding the full
   params (prefill) and its shard (16 query and 4 kv heads, half of
   every ``wq``/``wk``/``wv``/``w_gate``/``w_up`` column and
   ``wo``/``w_down`` row).  (a) Phase 4's prompts prefilled into each
   rank's kv-head shard of the pool and rank 0's tp 1 pool, then
   ``SERVE_TP_STEPS`` teacher-forced steps (the same seeded tokens): the
   tp 2 logits within ``BF16_TOL`` of tp 1's max |logit| at every step,
   32 launches of the decode kernel a step a rank; a fault scored beside
   the gate and required to fail it (layer ``SERVE_TP_FAULT_LAYER``'s
   ``w_down`` sum skipped, each rank keeping its partial); the same at 2
   layers in f32 (TF32 off) with every step's greedy tokens equal to tp
   1's; half of each slot's cold pages compressed in both pools, the
   e4m3 shards and scales bitwise rank 0's tp 1 pool's heads (the tp
   ``Max`` of the scales), and one compressed tp step (32 launches of
   the e4m3 variant a rank) bitwise the plain tp step over each rank's
   pool holding the dequantised rows.  (b) ``ServingEngine(mesh=)``
   serves phase 4's load: every request completes, no page left, both
   ranks' streams and reports identical (lock-step), 64 row-parallel
   allreduces a step and their bytes from ``collective_totals()``, 32
   decode launches a step and 32 flash launches a prefill a rank; token
   latency, TTFT and tokens/s beside phase 4's, and the streams' agreement
   with phase 4's tp 1 streams (logged: bf16 logits differ by the split).
   (c) ``ServingControlPlane(initial_tp=2)`` on the same load, a scripted
   shrink to 1 at decide-call 2 with ``drain_steps=0``: every request
   completes, nothing lost or leaked, one resize to tp 1, the tokens
   emitted before the shrink equal (b)'s, both ranks' reports identical,
   and the ``horovod_ctl_*`` families against the report
   (``examples.autoscale_probe.check_ctl_metrics``).  Phase 3 holds rows
   2 and 2b at the tp-local heads (16/4 and 8/2, ``check_decode_tp``).
30. item_1_12_rest -- (a) the disaggregated fleet with a tp 2 decode
   worker: this script run twice with ``--tp-worker fleet_tp`` on
   ``cuda:0`` over gloo, Llama-3 8B (full width and depth, bf16, seed 0)
   on phase 4's load, one prefill worker on rank 0 (the leader) and one
   ``ServingEngine(mesh=build_parallel_mesh(tp=2))`` over both ranks, a
   loopback ``RendezvousServer`` started here.  The f32 wire: every
   request completes, no page left on either rank, both ranks' streams
   and fleet reports equal, every stream equal to the colocated tp 2
   engine's (phase 29 (b)'s) on the same load, 8 handoffs streamed,
   ``kv_bytes_in == kv_bytes_out``.  The fp8 wire (``kv_compress``
   pools): every import's e4m3 shard and scales bitwise the rank's heads
   of the encoder's quantisation, and the streams equal a colocated tp 2
   ``kv_compress`` engine's that moves every full prompt page to the
   e4m3 pool as its request joins (it reads the same e4m3 pages); the
   first decode logits against the f32 wire's are logged.  A dead
   prefill worker (killed at the ``FLEET_TP_KILL_AFTER``-th import, on
   both ranks): the rest fall back to local prefill, nothing lost or
   leaked, the streams the f32 run's.  Launches on both ranks: 32 flash
   a prefill (the leader's, and the local ones), 32 decode (or e4m3
   decode) launches a step.  (b) The two-level DP leg: this script run
   four times with ``--tp-worker parallel_3d_dcn`` under
   ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``, BERT-Large (phase 12's cell,
   ``DCN_LAYERS`` deep, bf16, AdamW) through ``make_train_step`` on
   ``build_3d_mesh(data=2, dcn_size=2)``: a warm-up and a timed step,
   one step under ``ici:none,dcn:fp16``, each held against the 3-D step
   at world 1 here (phase 28 (a)'s, 64 x 128 tokens) -- the loss within
   1e-2 and each parameter's update within ``BF16_TOL`` or twice the
   world-1 step's own bf16-vs-f32 update distance (L2, relative to the
   reference update) -- and the bytes by leg equal to
   ``plan_hier_legs(n_dcn=2, n_ici=2)`` of the step's buckets; the fault
   (rank 0 joins the DCN allreduce but keeps its partial shard) must
   fail that gate; on ``build_3d_mesh(model=2, dcn_size=2)`` one ZeRO-1
   step (its arena from ``zero_init(param_specs=)``) against the same
   mesh without ZeRO, within the gate.  ``DCN_LAYERS`` flash forward, dq
   and dk/dv launches a step a rank; (b) within ``DCN_TIMEOUT``.

Phase 17 also holds ``chunked_allreduce`` (equal to ``allreduce`` at
world 1) and ``fp8_allreduce`` (bitwise its round trip) on its 64 MiB
buffer and times them.

Then one JSON line of per-kernel numbers, the card line, and last the
``{"ok": true, "device": ...}`` line.  Without a GPU, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores (NVIDIA data sheet)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (NVIDIA data sheet)
F32_TOL = 1e-5             # f32: absolute, the sums only reorder
F32_GRAD_TOL = 1e-5        # f32 gradients: relative to max |reference grad|
BF16_TOL = 2e-2            # bf16: relative to max |reference output|
BN_SUM_TOL = 1e-4          # BN dgamma/dbeta: relative to max |reference|,
                           # sums over up to 3.2 M rows in another order


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls
    (CUDA events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device time of one ``fn`` call: ``calls`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events.  The
    replay launches every kernel from the device's own queue, so this
    reads kernel time where ``time_ms`` of a ~0.05 ms call would read the
    host's enqueue rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def fused_update_launches(dev, card: str) -> None:
    """Each PowerSGD stage launch's own device time at the headline case
    (the 3880 x 3880 bucket, r = 4, f32 with a residual), as information:
    stage 2 is two launches.  Run last: run in phase 3, the
    ``torch.profiler`` session slowed phase 9's first timed step to 0.40 s
    (the others 0.13 s) on an H100."""
    from horovod_tpu_torch.collectives.compression import \
        powersgd_matrix_shape
    from horovod_tpu_torch.collectives.ops import _powersgd_seed_matrix
    from horovod_tpu_torch.ops import fused_update as fu

    size = POWERSGD_BUCKETS[0]
    m, c = powersgd_matrix_shape(size)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(size, generator=gen, device=dev)
    res = torch.randn(size, generator=gen, device=dev)
    q0 = _powersgd_seed_matrix(c, POWERSGD_RANK, dev)
    acc, p = fu.matricize_p(x, res, q0, rows=m)
    po, ql = fu.orthonormalize_q(acc, p)
    q = ql * 0.75 + 0.01
    log({"phase": "fused_update_launches", "card": card, "m": m, "c": c,
         "r": POWERSGD_RANK, "launch_ms": {
             "matricize_p": launch_ms(
                 lambda: fu.matricize_p(x, res, q0, rows=m)),
             "orthonormalize_q": launch_ms(
                 lambda: fu.orthonormalize_q(acc, p)),
             "reconstruct": launch_ms(lambda: fu.reconstruct_residual(
                 acc, po, q, ql, size=size))}})


def launch_ms(fn, calls: int = 20) -> dict:
    """Device time of each kernel ``fn`` launches, in ms a call of ``fn``
    (``torch.profiler`` over ``calls`` calls after a warm-up), keyed by the
    kernel's name with its template arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        m = re.search(r"(\w+_kernel(<[^>(]*>)?)", ev.key)
        name = m.group(1) if m else ev.key[:60]
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = H100_BF16_FLOPS) -> tuple:
    t_ops = flops / peak_flops
    t_bytes = nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mma_resources(build) -> dict:
    """Registers per thread and local-memory stack (spills) of the bf16
    tensor-core kernels, from ``cuobjdump`` of the built libraries."""
    out = {}
    for src, kernel in (("flash_fwd", "flash_fwd_mma_kernel"),
                        ("flash_bwd", "flash_bwd_dkv_mma_kernel"),
                        ("flash_bwd", "flash_bwd_dq_mma_kernel")):
        for sym, u in build.resource_usage(src).items():
            m = re.search(kernel + r"ILi(\d+)E", sym)
            if m:
                out[f"{kernel}<{m.group(1)}>"] = {
                    "registers": u["REG"], "stack_bytes": u.get("STACK", 0)}
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(attn, dev) -> dict:
    """Kernel A cases; returns the JSON entry at the headline shape
    (bf16, b=1, h=32, h_kv=8, d=128, causal, t=2048)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, hkv = 1, 32, 8
    cases = [dict(tq=t, tk=t) for t in (37, 512, 1000, 2048)]
    cases.append(dict(tq=256, tk=1280))
    cases.append(dict(tq=512, tk=4096))      # a 512-token prefill chunk
    cases.append(dict(tq=512, tk=512, seg=True))
    cases.append(dict(tq=1000, tk=1000, d=64))
    head = None
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases:
            tq, tk, d = case["tq"], case["tk"], case.get("d", 128)
            q = torch.randn(b, h, tq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype)
            v = torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype)
            kw = dict(causal=True, return_lse=True)
            if case.get("seg"):
                # Two packed segments; the last 6 query rows carry an id
                # no key has -> DEAD rows (O exactly 0, lse +1e30).
                qs = torch.zeros(b, tq, dtype=torch.int32, device=dev)
                qs[:, 256:] = 1
                qs[:, -6:] = 7
                ks = torch.zeros(b, tk, dtype=torch.int32, device=dev)
                ks[:, 256:] = 1
                kw.update(segment_ids=qs, kv_segment_ids=ks)
            o, lse = attn.flash_attention(q, k, v, **kw)
            o_ref, lse_ref = attn.flash_attention(q, k, v,
                                                  force_reference=True, **kw)
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            scale = o_ref.float().abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL * scale
            lse_err = (lse - lse_ref).abs().max().item()
            ok = err <= tol and lse_err <= 1e-3 and bool(
                torch.isfinite(o.float()).all())
            if case.get("seg"):
                ok = ok and o[:, :, -6:].abs().max().item() == 0.0 and bool(
                    (lse[:, :, -6:] == 1e30).all())
            # No atomics, a fixed order of sums: a second launch repeats
            # the bits.
            o2, lse2 = attn.flash_attention(q, k, v, **kw)
            repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
            ok = ok and repeat
            rec = {"phase": "kernel", "kernel": "flash_fwd",
                   "dtype": str(dtype).replace("torch.", ""), "tq": tq,
                   "tk": tk, "d": d, "segments": bool(case.get("seg")),
                   "max_abs_err": err, "tol": tol, "lse_err": lse_err,
                   "bitwise_repeat": repeat, "ok": ok}
            if dtype == torch.bfloat16 and tq == tk == 2048:
                flops = attn.attention_flops(b, h, tq, tk, d, True)
                nbytes = (2 * q.numel() + k.numel() + v.numel()
                          ) * q.element_size() + 4 * b * h * tq
                bms, by = bound_ms(flops, nbytes)
                ms = time_ms(lambda: attn.flash_attention(q, k, v,
                                                          causal=True))
                plain = time_ms(lambda: attn.flash_attention(
                    q, k, v, causal=True, force_reference=True), reps=5)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by,
                           tflops=flops / ms / 1e9)
                head = {"name": "flash_fwd", "route": "cuda",
                        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                        "replaces": "horovod_tpu/ops/attention.py:469",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib}
            log(rec)
            if not ok:
                raise AssertionError(f"flash_fwd disagrees: {rec}")
    return head


def check_decode(attn, dev) -> dict:
    """Kernel B cases at the serving shapes (8 slots, page 16, max_len
    4096, Llama-3 8B heads); returns the JSON entry at the headline case
    (bf16, 8 slots x 2048 live keys)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    slots, ps, max_len, h, hkv, d = 8, 16, 4096, 32, 8, 128
    pps = max_len // ps
    npages = slots * pps
    perm = torch.randperm(npages, generator=gen, device=dev)
    table = perm.view(slots, pps).to(torch.int32).contiguous()
    head = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, lens in (
                ("edges", [0, 1, 15, 17, 511, 512, 513, 4096]),
                ("main", [2048] * slots)):
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            # Large finite garbage everywhere, then live keys below each
            # length: any leak past a length shows up as a huge error.
            kp = torch.full((npages + 1, ps, hkv, d), 3e4, device=dev)
            vp = torch.full_like(kp, -3e4)
            pos = torch.arange(max_len, device=dev)
            for s in range(slots):
                live = pos < lens[s]
                pg = table[s].long()[pos[live] // ps]
                of = pos[live] % ps
                kp[pg, of] = torch.randn(int(live.sum()), hkv, d,
                                         generator=gen, device=dev)
                vp[pg, of] = torch.randn(int(live.sum()), hkv, d,
                                         generator=gen, device=dev)
            kp, vp = kp.to(dtype), vp.to(dtype)
            q = torch.randn(slots, h, 1, d, generator=gen, device=dev
                            ).to(dtype)
            o = attn.paged_decode_attention(q, kp, vp, table, lengths)
            o_ref = attn.paged_decode_attention(q, kp, vp, table, lengths,
                                                force_reference=True)
            # No atomics: a second launch repeats the bits.
            repeat = torch.equal(
                o, attn.paged_decode_attention(q, kp, vp, table, lengths))
            kc = attn.gather_pages(kp, table).contiguous()
            vc = attn.gather_pages(vp, table).contiguous()
            oc = attn.decode_attention(q, kc, vc, lengths=lengths)
            torch.cuda.synchronize()
            err = max((o.float() - o_ref.float()).abs().max().item(),
                      (oc.float() - o_ref.float()).abs().max().item())
            scale = o_ref.float().abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL * scale
            zero = [i for i, n in enumerate(lens) if n == 0]
            ok = err <= tol and bool(torch.isfinite(o.float()).all()) and \
                all(o[i].abs().max().item() == 0.0 for i in zero) and repeat
            rec = {"phase": "kernel", "kernel": "flash_decode",
                   "dtype": str(dtype).replace("torch.", ""),
                   "lengths": lens, "max_abs_err": err, "tol": tol,
                   "bitwise_repeat": repeat, "ok": ok}
            if dtype == torch.bfloat16 and name == "main":
                live = sum(lens)
                nbytes = (2 * live * hkv * d + 2 * q.numel()
                          ) * q.element_size() + 4 * slots * (pps + 1)
                flops = 4.0 * h * live * d
                bms, by = bound_ms(flops, nbytes)
                # Device time (split + merge) from a replayed graph, and
                # the library call timed the same way.
                ms = graph_ms(lambda: attn.paged_decode_attention(
                    q, kp, vp, table, lengths))
                plain = time_ms(lambda: attn.paged_decode_attention(
                    q, kp, vp, table, lengths, force_reference=True),
                    reps=5)
                # Library yardstick: one SDPA call on the already
                # gathered contiguous view, length mask as attn_mask.
                mask = (pos[None, None, None, :]
                        < lengths[:, None, None, None])
                lib = graph_ms(lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, enable_gqa=True))
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                head = {"name": "flash_decode", "route": "cuda",
                        "source":
                            "horovod_tpu_torch/ops/csrc/flash_decode.cu",
                        "replaces": "horovod_tpu/ops/attention.py:312",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib}
            log(rec)
            if not ok:
                raise AssertionError(f"flash_decode disagrees: {rec}")
            del kp, vp, kc, vc
    return head


def fp8_decode_case(dev, ps: int, seed: int, every: int = 2, h: int = 32,
                    hkv: int = 8) -> tuple:
    """8 slots x 2048 live keys of 4096, Llama-3 8B heads (or ``h`` query
    over ``hkv`` kv heads), bf16, at page size ``ps``; every ``every``-th
    full page (none at 0) compressed as
    ``PagedKVCache.compress_cold`` moves it (one scale a row; its table
    entry pointed at the garbage scratch page).  Returns ``(q, kp, vp,
    read, lengths, fp8, deq_k, deq_v, table)``: the pools and the table
    the e4m3 variant reads, and the pools holding the dequantised rows at
    the old pages with the table the plain kernel reads."""
    from horovod_tpu_torch.serving.kvcache import _quantize_pages
    gen = torch.Generator(device=dev).manual_seed(seed)
    slots, max_len, d, n = 8, 4096, 128, 2048
    pps = max_len // ps
    npages = slots * pps
    table = torch.randperm(npages, generator=gen, device=dev).view(
        slots, pps).to(torch.int32).contiguous()
    lengths = torch.full((slots,), n, dtype=torch.int32, device=dev)
    kp = torch.full((npages + 1, ps, hkv, d), 3e4, device=dev)
    vp = torch.full_like(kp, -3e4)
    live = table[:, :n // ps].reshape(-1).long()
    kp[live] = torch.randn(live.numel(), ps, hkv, d, generator=gen,
                           device=dev)
    vp[live] = torch.randn(live.numel(), ps, hkv, d, generator=gen,
                           device=dev)
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    cmask = torch.zeros((slots, pps), dtype=torch.bool, device=dev)
    if every:
        cmask[:, :n // ps:every] = True
    ctable = torch.randperm(npages, generator=gen, device=dev).view(
        slots, pps).to(torch.int32).contiguous()
    pids, cp = table[cmask].long(), ctable[cmask].long()
    kq = torch.zeros(kp.shape, dtype=torch.float8_e4m3fn, device=dev)
    vq = torch.zeros_like(kq)
    ksc = torch.ones(kp.shape[:2], dtype=torch.float32, device=dev)
    vsc = torch.ones_like(ksc)
    deq_k, deq_v = kp.clone(), vp.clone()
    pools = ((kp, kq, ksc, deq_k), (vp, vq, vsc, deq_v)) if every else ()
    for pool, qpool, sc, deq in pools:
        q8, scale = _quantize_pages(pool[None], pids)
        qpool.view(torch.uint8)[cp] = q8[0].view(torch.uint8)
        sc[cp] = scale[0]
        deq[pids] = (q8[0].float() * scale[0][..., None, None]).to(
            pool.dtype)
    read = table.clone()
    read[cmask] = npages                     # the scratch page: garbage
    q = torch.randn(slots, h, 1, d, generator=gen, device=dev).to(
        torch.bfloat16)
    return (q, kp, vp, read, lengths, (kq, vq, ksc, vsc, ctable, cmask),
            deq_k, deq_v, table)


def check_decode_fp8(attn, dev) -> dict:
    """The decode kernel's e4m3 variant at 8 slots x 2048 live keys, every
    other full page compressed: at page 16 (a 16-key tile is one page,
    all e4m3 or all bf16) and at page 8 (every tile mixes compressed and
    plain rows).  Each is bitwise the plain decode kernel over a pool
    holding the dequantised rows at the old pages, within the bf16
    tolerance of its plain version, and bitwise repeatable; both records
    carry the split kernel's registers, shared memory a CTA and CTAs an
    SM beside its uncompressed twin's.  Returns the page-16 JSON entry,
    timed from a replayed graph beside the uncompressed kernel on the
    dequantised pool in the same call."""
    rep = 32 // 8
    resources = {
        "fp8": attn.decode_resources(torch.bfloat16, 128, rep, fp8=True),
        "plain": attn.decode_resources(torch.bfloat16, 128, rep)}
    head = None
    for ps, seed in ((16, 5), (8, 6)):
        q, kp, vp, read, lengths, fp8, deq_k, deq_v, table = \
            fp8_decode_case(dev, ps, seed)

        def run():
            return attn.paged_decode_attention_fp8(q, kp, vp, read,
                                                   lengths, *fp8)

        o = run()
        plain_kernel = attn.paged_decode_attention(q, deq_k, deq_v, table,
                                                   lengths)
        o_ref = attn.paged_decode_attention_fp8(
            q, kp, vp, read, lengths, *fp8, force_reference=True)
        torch.cuda.synchronize()
        bitwise = torch.equal(o, plain_kernel)
        repeat = torch.equal(o, run())
        err = (o.float() - o_ref.float()).abs().max().item()
        tol = BF16_TOL * o_ref.float().abs().max().item()
        ok = bitwise and repeat and err <= tol and bool(
            torch.isfinite(o.float()).all())
        cmask = fp8[5]
        rec = {"phase": "kernel", "kernel": "flash_decode_fp8",
               "dtype": "bfloat16", "page_size": ps,
               "slots": q.shape[0], "keys": int(lengths[0]),
               "compressed_pages": int(cmask.sum()), "max_abs_err": err,
               "tol": tol,
               "bitwise_plain_kernel_on_dequantised_pool": bitwise,
               "bitwise_repeat": repeat, "split_kernel": resources}
        if ps == 16:
            # Bytes read once: e4m3 rows and a 4-byte scale each, bf16
            # rows, q and o, the two tables (int32), the mask (a byte)
            # and the lengths.
            slots, pps = cmask.shape
            hkv, d, n = kp.shape[2], kp.shape[3], int(lengths[0])
            cold = int(cmask.sum()) * ps
            hot = slots * n - cold
            nbytes = (2 * cold * (hkv * d + 4) + 2 * hot * hkv * d * 2
                      + 2 * q.numel() * 2 + slots * (9 * pps + 4))
            bms, by = bound_ms(4.0 * q.shape[1] * slots * n * d, nbytes)
            ms = graph_ms(run)
            off_ms = graph_ms(lambda: attn.paged_decode_attention(
                q, deq_k, deq_v, table, lengths))
            plain = time_ms(lambda: attn.paged_decode_attention_fp8(
                q, kp, vp, read, lengths, *fp8, force_reference=True),
                reps=5)
            rec.update(ms=ms, uncompressed_kernel_ms=off_ms,
                       plain_ms=plain, bound_ms=bms, bound_by=by,
                       bytes=nbytes, bound_share=bms / ms)
            head = {"name": "flash_decode_fp8", "route": "cuda",
                    "source": "horovod_tpu_torch/ops/csrc/flash_decode.cu",
                    "replaces": "horovod_tpu/ops/attention.py:312 with the "
                                "e4m3 gather blend at "
                                "horovod_tpu/serving/decode.py:397",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": None}
        rec["ok"] = ok
        log(rec)
        if not ok:
            raise AssertionError(f"flash_decode_fp8 disagrees: {rec}")
        del kp, vp, deq_k, deq_v, fp8
    return head


DECODE_TP_HEADS = ((2, 16, 4), (4, 8, 2))   # (tp, q heads, kv heads) a
                                             # rank of Llama-3 8B's step


def check_decode_tp(attn, dev) -> list:
    """Rows 2 and 2b at the heads a rank of phase 29's tensor-parallel
    decode step holds (``DECODE_TP_HEADS``), 8 slots x 2048 keys of 4096,
    bf16, page 16: each within the bf16 tolerance of its plain version,
    the e4m3 variant (every other full page compressed) bitwise the plain
    kernel on the dequantised pool, both bitwise repeatable; each timed
    from a replayed graph beside its bound, its plain version and (row 2)
    SDPA on the gathered view.  Returns the records (the kernel table's
    sub-rows)."""
    out = []
    for tp, h, hkv in DECODE_TP_HEADS:
        q, kp, vp, read, lengths, fp8, deq_k, deq_v, table = \
            fp8_decode_case(dev, 16, 40 + tp, h=h, hkv=hkv)
        slots, pps = table.shape
        d, n, ps = kp.shape[3], int(lengths[0]), kp.shape[1]
        cmask = fp8[5]
        flops = 4.0 * h * slots * n * d
        runs = {
            "flash_decode": (
                lambda: attn.paged_decode_attention(q, deq_k, deq_v, table,
                                                    lengths),
                lambda: attn.paged_decode_attention(
                    q, deq_k, deq_v, table, lengths, force_reference=True),
                (2 * slots * n * hkv * d + 2 * q.numel()) * 2
                + 4 * slots * (pps + 1)),
            "flash_decode_fp8": (
                lambda: attn.paged_decode_attention_fp8(q, kp, vp, read,
                                                        lengths, *fp8),
                lambda: attn.paged_decode_attention_fp8(
                    q, kp, vp, read, lengths, *fp8, force_reference=True),
                2 * int(cmask.sum()) * ps * (hkv * d + 4)
                + 2 * (slots * n - int(cmask.sum()) * ps) * hkv * d * 2
                + 2 * q.numel() * 2 + slots * (9 * pps + 4))}
        first = None
        for name, (run, plain_fn, nbytes) in runs.items():
            o = run()
            o_ref = plain_fn()
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            tol = BF16_TOL * o_ref.float().abs().max().item()
            repeat = torch.equal(o, run())
            ok = err <= tol and repeat and bool(
                torch.isfinite(o.float()).all())
            rec = {"phase": "kernel", "kernel": name, "tp": tp,
                   "heads": h, "kv_heads": hkv, "dtype": "bfloat16",
                   "slots": slots, "keys": n, "page_size": ps,
                   "max_abs_err": err, "tol": tol, "bitwise_repeat": repeat}
            if name == "flash_decode":
                first = o
                kc = attn.gather_pages(deq_k, table).contiguous()
                vc = attn.gather_pages(deq_v, table).contiguous()
                pos = torch.arange(pps * ps, device=dev)
                mask = pos[None, None, None, :] < lengths[:, None, None,
                                                          None]
                lib = graph_ms(lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, enable_gqa=True))
                del kc, vc
            else:
                rec["compressed_pages"] = int(cmask.sum())
                rec["bitwise_plain_kernel_on_dequantised_pool"] = \
                    torch.equal(o, first)
                ok = ok and rec["bitwise_plain_kernel_on_dequantised_pool"]
                lib = None
            bms, by = bound_ms(flops, nbytes)
            ms = graph_ms(run)
            rec.update(ms=ms, plain_ms=time_ms(plain_fn, reps=5),
                       library_ms=lib, bound_ms=bms, bound_by=by,
                       bound_share=bms / ms, ok=ok)
            log(rec)
            out.append(rec)
            if not ok:
                raise AssertionError(f"{name} at tp {tp} disagrees: {rec}")
        del q, kp, vp, fp8, deq_k, deq_v
    return out


def check_flash_bwd(attn, dev) -> tuple:
    """The backward's dq and dk/dv kernels at the training shapes (b=2,
    h=32, h_kv=8, d=128, causal); returns the JSON entries of both at the
    headline case (bf16, t=2048)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, hkv = 2, 32, 8
    cases = [dict(tq=t, tk=t) for t in (37, 512, 1000, 2048)]
    cases.append(dict(tq=256, tk=1280))
    cases.append(dict(tq=512, tk=4096))      # a 512-token prefill chunk
    cases.append(dict(tq=512, tk=512, seg=True))
    cases.append(dict(tq=1000, tk=1000, d=64))
    cases.append(dict(tq=512, tk=512, f32=True))
    heads = None
    for case in cases:
        tq, tk, d = case["tq"], case["tk"], case.get("d", 128)
        dtype = torch.float32 if case.get("f32") else torch.bfloat16
        q, do = (torch.randn(b, h, tq, d, generator=gen, device=dev
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=True)
        if case.get("seg"):
            # Two packed segments; the last 6 query rows carry an id no
            # key has (DEAD rows: dq exactly 0) and the last 4 keys an id
            # no query has (dk, dv exactly 0).
            qs = torch.zeros(b, tq, dtype=torch.int32, device=dev)
            qs[:, 256:] = 1
            qs[:, -6:] = 7
            ks = torch.zeros(b, tk, dtype=torch.int32, device=dev)
            ks[:, 256:] = 1
            ks[:, -4:] = 8
            kw.update(segment_ids=qs, kv_segment_ids=ks)
        o, lse = attn.flash_attention(q, k, v, return_lse=True, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = (attn.flash_backward_dq(*args, **kw),
               *attn.flash_backward_dkv(*args, **kw))
        want = (attn.flash_backward_dq(*args, force_reference=True, **kw),
                *attn.flash_backward_dkv(*args, force_reference=True, **kw))
        torch.cuda.synchronize()
        rel = F32_GRAD_TOL if dtype == torch.float32 else BF16_TOL
        errs, tols = [], []
        ok = True
        for g, w in zip(got, want):
            errs.append((g.float() - w.float()).abs().max().item())
            tols.append(rel * w.float().abs().max().item())
            ok = ok and errs[-1] <= tols[-1] and bool(
                torch.isfinite(g.float()).all())
        if case.get("seg"):
            ok = ok and got[0][:, :, -6:].abs().max().item() == 0.0 and \
                max(x[:, :, -4:].abs().max().item() for x in got[1:]) == 0.0
        # No atomics (dk/dv sum over the GQA group inside one CTA): a
        # second launch of each repeats the bits.
        again = (attn.flash_backward_dq(*args, **kw),
                 *attn.flash_backward_dkv(*args, **kw))
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = ok and repeat
        rec = {"phase": "kernel", "kernel": "flash_bwd",
               "dtype": str(dtype).replace("torch.", ""), "tq": tq,
               "tk": tk, "d": d, "segments": bool(case.get("seg")),
               "max_abs_err": dict(zip(("dq", "dk", "dv"), errs)),
               "tol": dict(zip(("dq", "dk", "dv"), tols)),
               "bitwise_repeat": repeat, "ok": ok}
        if dtype == torch.bfloat16 and tq == tk == 2048:
            rec["timing"], heads = time_flash_bwd(attn, args, errs)
        log(rec)
        if not ok:
            raise AssertionError(f"flash_bwd disagrees: {rec}")
        del q, k, v, do, o, lse, delta, args, got, want, again
    return heads


def time_flash_bwd(attn, args, errs) -> tuple:
    """Kernel, plain and bound times of dq and dk/dv at the headline
    shape, and the library yardstick: the backward of one SDPA call
    (``autograd.grad`` of its output, forward timed apart and
    subtracted), which computes dq, dk and dv together."""
    q, k, v, do, lse, delta = args
    b, h, t, d = q.shape
    hkv = k.shape[1]
    esz = q.element_size()
    stats = 2 * 4 * b * h * t                       # lse + delta, f32
    ms_dq = time_ms(lambda: attn.flash_backward_dq(*args, causal=True),
                    reps=10)
    ms_dkv = time_ms(lambda: attn.flash_backward_dkv(*args, causal=True),
                     reps=10)
    plain_dq = time_ms(lambda: attn.flash_backward_dq(
        *args, causal=True, force_reference=True), reps=3, warmup=1)
    plain_dkv = time_ms(lambda: attn.flash_backward_dkv(
        *args, causal=True, force_reference=True), reps=3, warmup=1)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=True)

    fwd = time_ms(sdpa)
    both = time_ms(lambda: torch.autograd.grad(sdpa(), (qr, kr, vr), do))
    lib = both - fwd
    # dq reads q, dO, k, v, lse, delta and writes dq; dk/dv reads the same
    # and writes dk, dv.
    q_bytes = (3 * b * h * t * d + 2 * b * hkv * t * d) * esz + stats
    kv_bytes = (2 * b * h * t * d + 4 * b * hkv * t * d) * esz + stats
    fl_dq = attn.attention_flops(b, h, t, t, d, True, 3)
    fl_dkv = attn.attention_flops(b, h, t, t, d, True, 4)
    b_dq, by_dq = bound_ms(fl_dq, q_bytes)
    b_dkv, by_dkv = bound_ms(fl_dkv, kv_bytes)
    src = "horovod_tpu_torch/ops/csrc/flash_bwd.cu"
    entries = (
        {"name": "flash_bwd_dq", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/attention.py:622",
         "max_abs_err": errs[0], "ms": ms_dq, "plain_ms": plain_dq,
         "bound_ms": b_dq, "bound_by": by_dq, "library_ms": lib},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/attention.py:655",
         "max_abs_err": max(errs[1:]), "ms": ms_dkv, "plain_ms": plain_dkv,
         "bound_ms": b_dkv, "bound_by": by_dkv, "library_ms": lib})
    timing = {"dq_ms": ms_dq, "dkv_ms": ms_dkv, "plain_dq_ms": plain_dq,
              "plain_dkv_ms": plain_dkv, "sdpa_fwd_ms": fwd,
              "sdpa_fwd_bwd_ms": both, "library_bwd_ms": lib,
              "bound_dq_ms": b_dq, "bound_dkv_ms": b_dkv,
              "dq_tflops": fl_dq / ms_dq / 1e9,
              "dkv_tflops": fl_dkv / ms_dkv / 1e9}
    return timing, entries


# BERT's attention: BERT-Large's 16 heads of 64, bidirectional; phase-1
# pretraining (b = 64, t = 128) and phase 2's longest rows (b = 4, t = 512)
# packed with two segments of unequal lengths.
BERT_ATTN_CASES = ((64, 128, False), (4, 512, True))


def bert_segments(b: int, t: int, dev) -> torch.Tensor:
    """Two packed segments of unequal lengths a row, the split moving
    from row to row (at 3/8 of the row, then 16 tokens later a row)."""
    seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for r in range(b):
        seg[r, 3 * t // 8 + 16 * r:] = 1
    return seg


def check_bert_attention(attn, dev, card: str) -> None:
    """The forward, dq and dk/dv kernels at BERT's shapes against their
    plain versions (bf16), and -- as information -- their times beside
    SDPA's and their bounds.  With segments the bounds count the pairs
    this run's segments keep.  Every time is device time from a replayed
    CUDA graph (``graph_ms``): CUDA events around back-to-back calls of a
    0.05 ms kernel read the host's launch rate."""
    gen = torch.Generator(device=dev).manual_seed(9)
    h, d = 16, 64
    cases = []
    for b, t, seg in BERT_ATTN_CASES:
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev
                                   ).to(torch.bfloat16) for _ in range(4))
        kw = dict(causal=False)
        mask = None
        pairs = b * t * t
        if seg:
            ids = bert_segments(b, t, dev)
            kw.update(segment_ids=ids, kv_segment_ids=ids)
            mask = ids[:, None, :, None] == ids[:, None, None, :]
            pairs = int(mask.sum())
        o, lse = attn.flash_attention(q, k, v, return_lse=True, **kw)
        o_ref, lse_ref = attn.flash_attention(q, k, v, return_lse=True,
                                              force_reference=True, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = (o, attn.flash_backward_dq(*args, **kw),
               *attn.flash_backward_dkv(*args, **kw))
        want = (o_ref, attn.flash_backward_dq(*args, force_reference=True,
                                              **kw),
                *attn.flash_backward_dkv(*args, force_reference=True, **kw))
        torch.cuda.synchronize()
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        tols = [BF16_TOL * w.float().abs().max().item() for w in want]
        lse_err = (lse - lse_ref).abs().max().item()
        ok = all(e <= tl for e, tl in zip(errs, tols)) and \
            lse_err <= 1e-3 and all(bool(torch.isfinite(g.float()).all())
                                    for g in got)
        ms = {"fwd": graph_ms(lambda: attn.flash_attention(q, k, v, **kw)),
              "dq": graph_ms(lambda: attn.flash_backward_dq(*args, **kw)),
              "dkv": graph_ms(lambda: attn.flash_backward_dkv(*args, **kw))}
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)

        sdpa_fwd = graph_ms(sdpa)
        sdpa_bwd = graph_ms(lambda: torch.autograd.grad(
            sdpa(), (qr, kr, vr), do)) - sdpa_fwd
        esz, stats = q.element_size(), 2 * 4 * b * h * t
        ids_bytes = 2 * 4 * b * t if seg else 0
        tensor = b * h * t * d * esz
        bounds = {
            "fwd": bound_ms(4.0 * h * d * pairs,
                            4 * tensor + 4 * b * h * t + ids_bytes),
            "dq": bound_ms(6.0 * h * d * pairs, 5 * tensor + stats
                           + ids_bytes),
            "dkv": bound_ms(8.0 * h * d * pairs, 6 * tensor + stats
                            + ids_bytes)}
        cases.append({
            "b": b, "h": h, "t": t, "d": d, "causal": False,
            "segments": seg, "pairs": pairs,
            "max_abs_err": dict(zip(("o", "dq", "dk", "dv"), errs)),
            "tol": dict(zip(("o", "dq", "dk", "dv"), tols)),
            "lse_err": lse_err, "ms": ms,
            "bound_ms": {n: x[0] for n, x in bounds.items()},
            "bound_by": {n: x[1] for n, x in bounds.items()},
            "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd, "ok": ok})
        del q, k, v, do, o, lse, o_ref, lse_ref, delta, args, got, want
        del qr, kr, vr, mask
    log({"phase": "bert_attention", "card": card, "cases": cases})
    if not all(c["ok"] for c in cases):
        raise AssertionError("attention kernels disagree at BERT's shapes")


# The BN cases: a ragged N with C below one vector and not a multiple of
# 8, a C of exactly one vector, three ResNet-50 sites at batch 256 (the
# stem, stage 1's widest, stage 4) and six Inception-v3 sites at batch 32
# (the first stem site; C = 80, 192, 2048 on the 8 x 8 grid; and two
# widths that span two 256-channel tiles and end in a partial one: 448 on
# the 8 x 8 grid and 384 on the 17 x 17 grid).
BN_CASES = ((37, 3), (1000, 8), (3211264, 64), (802816, 256), (12544, 2048),
            (710432, 32), (2048, 80), (2048, 192), (2048, 2048), (2048, 448),
            (9248, 384))
BN_HEADLINE = (802816, 256)        # [256 x 56 x 56, 256], bf16
# The timed cases and their [batch, h, w] (the library call's 4-D view):
# the headline, and Inception's most rows and widest channels.
BN_TIMED = {BN_HEADLINE: (256, 56, 56), (710432, 32): (32, 149, 149),
            (2048, 2048): (32, 8, 8)}


def check_bn_bwd(bn, dev) -> tuple:
    """The BatchNorm backward's two kernels against their plain versions
    on every case of ``BN_CASES``, bf16 and f32; returns the JSON entries
    of both at the headline case (bf16 ``[802816 x 256]``)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    heads = None
    for dtype in (torch.bfloat16, torch.float32):
        for n, c in BN_CASES:
            x = (2.0 * torch.randn(n, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            dy = torch.randn(n, c, generator=gen, device=dev).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
            mean, var = bn.batch_stats(x)
            inv = torch.rsqrt(var + 1e-5)
            got = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
            want = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5,
                                        force_reference=True)
            torch.cuda.synchronize()
            rels = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
                    BN_SUM_TOL, BN_SUM_TOL)
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
            tols = [r * w.float().abs().max().item()
                    for r, w in zip(rels, want)]
            ok = all(e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(g.float()).all()) for g in got) and \
                got[0].dtype == dtype and got[1].dtype == torch.float32
            rec = {"phase": "kernel", "kernel": "bn_bwd",
                   "dtype": str(dtype).replace("torch.", ""), "n": n,
                   "c": c, "chunks": bn.reduce_chunks(n, c),
                   "max_abs_err": dict(zip(("dx", "dgamma", "dbeta"), errs)),
                   "tol": dict(zip(("dx", "dgamma", "dbeta"), tols)),
                   "ok": ok}
            if dtype == torch.bfloat16 and (n, c) in BN_TIMED:
                rec["timing"], entries = time_bn_bwd(
                    bn, x, dy, mean, var, inv, scale, got, errs,
                    BN_TIMED[n, c])
                if (n, c) == BN_HEADLINE:
                    heads = entries
                ok = ok and rec["timing"]["deterministic"]
                rec["ok"] = ok
            log(rec)
            if not ok:
                raise AssertionError(f"bn_bwd disagrees: {rec}")
            del x, dy, got, want
    return heads


def time_bn_bwd(bn, x, dy, mean, var, inv, scale, got, errs,
                view: tuple) -> tuple:
    """Kernel, plain and bound times of both passes at one shape, a
    repeat launch that must give bitwise the same results, and the
    library yardstick: one ``native_batch_norm_backward`` on the
    channels-last 4-D view ``[batch, h, w, c]`` with the saved mean and
    inverse std, train mode, all three outputs (it computes both passes,
    so both rows carry its time).  The kernels' and the library call's
    times are device time from a replayed CUDA graph: at Inception's
    8 x 8 grid a pass is a few microseconds, and CUDA events around
    back-to-back calls would read the host's launch rate."""
    n, c = x.shape
    esz = x.element_size()
    dx, dgamma, dbeta = got
    again = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    deterministic = all(torch.equal(a, b) for a, b in zip(again, got))
    ms_red = graph_ms(lambda: bn.bn_backward_reduce(x, dy, mean, inv))
    ms_dx = graph_ms(lambda: bn.bn_backward_dx(x, dy, mean, inv, scale,
                                               dbeta, dgamma))
    plain_red = time_ms(lambda: bn.bn_backward_reduce(
        x, dy, mean, inv, force_reference=True), reps=5)
    plain_dx = time_ms(lambda: bn.bn_backward_dx(
        x, dy, mean, inv, scale, dbeta, dgamma, force_reference=True),
        reps=5)
    lib_dtype = str(x.dtype).replace("torch.", "")

    def library(xl, dyl):
        x4 = xl.view(*view, c).permute(0, 3, 1, 2)
        dy4 = dyl.view(*view, c).permute(0, 3, 1, 2)
        return lambda: torch.ops.aten.native_batch_norm_backward(
            dy4, x4, scale, None, None, mean, inv, True, 1e-5,
            [True, True, True])
    try:
        lib = graph_ms(library(x, dy))
    except RuntimeError:
        # bf16 input with an f32 weight refused: time it on f32 copies.
        lib_dtype = "float32"
        lib = graph_ms(library(x.float(), dy.float()))
    rows = 4 * c
    # Pass 1 reads x, dy, mean, inv and writes dbeta, dgamma; pass 2 reads
    # x, dy and five rows and writes dx.  f32 work per element: xhat (2),
    # two sums (3); pass 2 xhat (2) and dx (4).
    b_red, by_red = bound_ms(5.0 * n * c, 2 * n * c * esz + 4 * rows,
                             H100_F32_FLOPS)
    b_dx, by_dx = bound_ms(6.0 * n * c, 3 * n * c * esz + 5 * rows,
                           H100_F32_FLOPS)
    src = "horovod_tpu_torch/ops/csrc/bn_bwd.cu"
    entries = (
        {"name": "bn_bwd_reduce", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/bn.py:107",
         "max_abs_err": max(errs[1:]), "ms": ms_red, "plain_ms": plain_red,
         "bound_ms": b_red, "bound_by": by_red, "library_ms": lib},
        {"name": "bn_bwd_dx", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/bn.py:116",
         "max_abs_err": errs[0], "ms": ms_dx, "plain_ms": plain_dx,
         "bound_ms": b_dx, "bound_by": by_dx, "library_ms": lib})
    timing = {"reduce_ms": ms_red, "dx_ms": ms_dx,
              "plain_reduce_ms": plain_red, "plain_dx_ms": plain_dx,
              "library_ms": lib, "library_dtype": lib_dtype,
              "bound_reduce_ms": b_red, "bound_dx_ms": b_dx,
              "deterministic": deterministic}
    return timing, entries


# ResNet-50's two error-feedback buckets under powersgd:4 (forward flax
# leaf order, 64 MiB threshold): 76 leaves of 15,053,824 values, viewed as
# [3880, 3880] (pad 576), and 85 of 10,506,088 as [3242, 3241] (pad 1234).
POWERSGD_RANK = 4
POWERSGD_BUCKETS = (15053824, 10506088)
POWERSGD_WIRE_BYTES = 227888   # 4 r (m + c) f32 over both buckets a step
POWERSGD_TOL = 1e-5            # stages: relative to max |plain|, sums of up
                               # to 3,880 terms in another order
POWERSGD_STEP_TOL = 1e-4       # a step's whole exchange, kernels vs plain
# Stage-3 scalings: Average at world 1, and Sum's n with a postscale.
POWERSGD_SCALINGS = (("average", 1.0, 1.0, 1.0),
                     ("sum_postscale", 0.5, 2.0, 0.25))


def powersgd_stage_pairs(fu, x, res, q0, m, size, pre, n_scale, post):
    """The three PowerSGD stages through the kernels and through their
    plain versions, each kernel fed the plain chain's inputs; a mean Q
    unlike this rank's own feeds stage 3.  Returns ``(kernel outputs,
    plain outputs)``: acc, p, p_orth, q_local, out, residual."""
    acc_w, p_w = fu.matricize_p(x, res, q0, rows=m, prescale=pre,
                                force_reference=True)
    po_w, ql_w = fu.orthonormalize_q(acc_w, p_w, force_reference=True)
    q = ql_w * 0.75 + 0.01
    out_w, res_w = fu.reconstruct_residual(
        acc_w, po_w, q, ql_w, size=size, n_scale=n_scale, postscale=post,
        force_reference=True)
    acc, p = fu.matricize_p(x, res, q0, rows=m, prescale=pre)
    po, ql = fu.orthonormalize_q(acc_w, p_w)
    out, new_res = fu.reconstruct_residual(acc_w, po_w, q, ql_w, size=size,
                                           n_scale=n_scale, postscale=post)
    return ((acc, p, po, ql, out, new_res),
            (acc_w, p_w, po_w, ql_w, out_w, res_w), q)


def check_fused_update(dev) -> tuple:
    """The PowerSGD exchange's three kernels against their plain versions
    at both ResNet-50 bucket shapes, with and without a residual, r = 1
    and r = 4, Average and Sum with a postscale; returns the JSON entries
    of the three at the headline case (the 3880 x 3880 bucket, r = 4,
    with a residual, Average)."""
    from horovod_tpu_torch.collectives.compression import \
        powersgd_matrix_shape
    from horovod_tpu_torch.collectives.ops import _powersgd_seed_matrix
    from horovod_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=dev).manual_seed(7)
    names = ("acc", "p", "p_orth", "q_local", "out", "residual")
    worst = dict.fromkeys(names, 0.0)
    heads = None
    for size in POWERSGD_BUCKETS:
        m, c = powersgd_matrix_shape(size)
        for r in (1, POWERSGD_RANK):
            q0 = _powersgd_seed_matrix(c, r, dev)
            for residual in (False, True):
                x = torch.randn(size, generator=gen, device=dev)
                res = torch.randn(size, generator=gen, device=dev) \
                    if residual else None
                for scaling, pre, n_scale, post in POWERSGD_SCALINGS:
                    got, want, q = powersgd_stage_pairs(
                        fu, x, res, q0, m, size, pre, n_scale, post)
                    torch.cuda.synchronize()
                    errs = {n: (g - w).abs().max().item()
                            for n, g, w in zip(names, got, want)}
                    tols = {n: 0.0 if n == "acc" else
                            POWERSGD_TOL * w.abs().max().item()
                            for n, w in zip(names, want)}
                    ok = all(errs[n] <= tols[n] for n in names) and all(
                        bool(torch.isfinite(g).all()) for g in got) and \
                        bool((got[0].reshape(-1)[size:] == 0).all())
                    rec = {"phase": "kernel", "kernel": "fused_update",
                           "size": size, "m": m, "c": c, "r": r,
                           "residual": residual, "scaling": scaling,
                           "max_abs_err": errs,
                           "tol": tols, "ok": ok}
                    for n in names:
                        worst[n] = max(worst[n], errs[n])
                    if (size, r, residual, scaling) == (
                            POWERSGD_BUCKETS[0], POWERSGD_RANK, True,
                            "average"):
                        rec["timing"], heads = time_fused_update(
                            fu, x, res, q0, m, size, got, want, q)
                        ok = ok and rec["timing"]["deterministic"]
                        rec["ok"] = ok
                    log(rec)
                    if not ok:
                        raise AssertionError(f"fused_update disagrees: "
                                             f"{rec}")
                    del got, want, q
                del x, res
    errs = (max(worst["acc"], worst["p"]),
            max(worst["p_orth"], worst["q_local"]),
            max(worst["out"], worst["residual"]))
    for e, err in zip(heads, errs):
        e["max_abs_err"] = err
    return heads


def time_fused_update(fu, x, res, q0, m, size, got, want, q) -> tuple:
    """Kernel, plain and bound times of the three stages at the headline
    case, a repeat launch of each that must give bitwise the same outputs,
    and -- as information only, since no one PyTorch call computes any of
    the three -- cuBLAS-backed ``torch.add`` + ``torch.mm`` chains that do
    each stage's arithmetic.  A stage's time is device time from a
    replayed CUDA graph (``graph_ms``): CUDA events around back-to-back
    wrapper calls of a 0.03 ms stage read the host's launch rate."""
    c, r = q0.shape
    acc_w, p_w, po_w, ql_w = want[:4]
    again = (*fu.matricize_p(x, res, q0, rows=m),
             *fu.orthonormalize_q(acc_w, p_w),
             *fu.reconstruct_residual(acc_w, po_w, q, ql_w, size=size))
    deterministic = all(torch.equal(a, b) for a, b in zip(again, got))
    stages = (lambda: fu.matricize_p(x, res, q0, rows=m),
              lambda: fu.orthonormalize_q(acc_w, p_w),
              lambda: fu.reconstruct_residual(acc_w, po_w, q, ql_w,
                                              size=size))
    ms = tuple(graph_ms(fn) for fn in stages)
    plain = (time_ms(lambda: fu.matricize_p(x, res, q0, rows=m,
                                            force_reference=True), reps=5),
             time_ms(lambda: fu.orthonormalize_q(acc_w, p_w,
                                                 force_reference=True),
                     reps=5),
             time_ms(lambda: fu.reconstruct_residual(
                 acc_w, po_w, q, ql_w, size=size, force_reference=True),
                 reps=5))
    x_mat = F.pad(x, (0, m * c - size)).view(m, c)
    res_mat = F.pad(res, (0, m * c - size)).view(m, c)
    lib = (time_ms(lambda: torch.mm(torch.add(x_mat, res_mat), q0)),
           time_ms(lambda: torch.mm(acc_w.T, po_w)),
           time_ms(lambda: (torch.mm(po_w, q.T),
                            torch.sub(acc_w, torch.mm(po_w, ql_w.T)))))
    # Bytes each stage must move, each input read once and each output
    # written once; f32 work: stage 1 the residual add and r products
    # (2 r), stage 2 the projection (2 r) and Gram-Schmidt's r (r + 1) / 2
    # dot products and updates over m rows, stage 3 two r-term sums and
    # the subtraction.  All f32, off the tensor cores.
    mc, fac_m, fac_c = m * c, 4 * m * r, 4 * c * r
    nbytes = (size * (x.element_size() + 4) + 4 * mc + fac_c + fac_m,
              4 * mc + 3 * fac_m + fac_c,
              12 * size + fac_m + 2 * fac_c)
    flops = (size + 2.0 * r * mc,
             2.0 * r * mc + 4.0 * m * r * (r + 1) / 2 + 3.0 * m * r,
             (4.0 * r + 1) * size)
    bounds = [bound_ms(f, b, H100_F32_FLOPS) for f, b in zip(flops, nbytes)]
    src = "horovod_tpu_torch/ops/csrc/fused_update.cu"
    rows = (("fused_update_matricize_p", 99),
            ("fused_update_orthonormalize_q", 152),
            ("fused_update_reconstruct", 205))
    entries = tuple(
        {"name": name, "route": "cuda", "source": src,
         "replaces": f"horovod_tpu/ops/fused_update.py:{line}",
         "ms": t, "plain_ms": pt, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": None}
        for (name, line), t, pt, b in zip(rows, ms, plain, bounds))
    timing = {"matricize_p_ms": ms[0], "orthonormalize_q_ms": ms[1],
              "reconstruct_ms": ms[2], "plain_ms": list(plain),
              "bound_ms": [b[0] for b in bounds],
              "bound_by": [b[1] for b in bounds], "bytes": list(nbytes),
              "add_mm_info_ms": list(lib),
              "deterministic": deterministic}
    return timing, entries


# ---------------------------------------------------------------------------
# Phase 4: the serving slice end to end
# ---------------------------------------------------------------------------


SERVE_LOAD = dict(num_requests=8, prompt_lens=(37, 512, 2048),
                  output_lens=(32, 64), seed=0)
SERVE_GEOM = dict(slots=8, page_size=16, max_len=4096)


def serve_llama(dev, card: str) -> tuple:
    """Phase 4; returns the kernels' launch counts and the run (its
    report and every request's token stream, for phase 26)."""
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.serving import (LoadSpec, Request, ServingEngine,
                                           generate, prefill_forward)

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=torch.bfloat16,
                               device=dev)
    torch.cuda.synchronize()
    log({"phase": "init", "config": "LLAMA3_8B", "layers": cfg.num_layers,
         "dtype": "bfloat16", "seconds": time.perf_counter() - t0,
         "param_bytes": sum(t.numel() * t.element_size()
                            for t in params.values())})
    eng = ServingEngine(cfg, params, device=dev, dtype=torch.bfloat16,
                        **SERVE_GEOM)
    # Warm-up: one short request (cuBLAS handles, allocator, kernels).
    warm = Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                   max_new_tokens=2)
    eng.serve([warm])

    spec = LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD)
    reqs = generate(spec)
    registry.reset_launch_counts()
    report = eng.serve(reqs)
    counts = registry.launch_counts()
    rep = report.as_dict()
    log({"phase": "serve", "card": card, **rep, "launches": counts})
    if report.completed != spec.num_requests:
        raise AssertionError(f"completed {report.completed} != 8")
    for r in reqs:
        if not r.tokens or any(not 0 <= t < cfg.vocab_size
                               for t in r.tokens):
            raise AssertionError(f"request {r.rid}: bad tokens")
    if counts["flash"] != cfg.num_layers * report.prefills:
        raise AssertionError(f"flash launches {counts['flash']} != "
                             f"{cfg.num_layers} x {report.prefills}")
    if counts["flash_decode"] != cfg.num_layers * report.decode_steps:
        raise AssertionError(
            f"flash_decode launches {counts['flash_decode']} != "
            f"{cfg.num_layers} x {report.decode_steps}")

    # First request's first-token logits: kernels vs plain attention.
    prompt = torch.tensor(reqs[0].prompt, dtype=torch.long, device=dev)[None]
    got = prefill_forward(params, cfg, prompt, dtype=torch.bfloat16)[0]
    want = prefill_forward(params, cfg, prompt, dtype=torch.bfloat16,
                           force_reference=True)[0]
    got, want = got[0, -1], want[0, -1]
    err = (got - want).abs().max().item()
    tol = BF16_TOL * want.abs().max().item()
    same_token = int(got.argmax()) == int(want.argmax()) == reqs[0].tokens[0]
    log({"phase": "logits", "prompt_len": int(prompt.shape[1]),
         "max_abs_err": err, "tol": tol, "argmax_agrees": same_token})
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError("first-token logits disagree with the plain "
                             "prefill")
    return counts, {"report": rep,
                    "streams": {r.rid: list(r.tokens) for r in reqs}}


# ---------------------------------------------------------------------------
# Phases 5-6: the training slice
# ---------------------------------------------------------------------------


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lora_model(cfg, dev, seed: int, nonzero_b: bool):
    """Llama at ``cfg`` with random bf16 base weights and f32 LoRA rank-8
    adapters from ``seed``; ``nonzero_b`` draws ``lora_b`` too (else zero,
    the standard init).  The base is frozen."""
    from horovod_tpu_torch.models import (LlamaLM, freeze_base,
                                          init_llama_params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_llama_params(cfg, generator=gen, dtype=torch.bfloat16,
                               device=dev, lora_rank=8)
    if nonzero_b:
        for name, t in params.items():
            if name.endswith(".lora_b"):
                t.normal_(0.0, 0.02, generator=gen)
    model = LlamaLM.from_params(cfg, params, dtype=torch.bfloat16,
                                lora_rank=8)
    return model, freeze_base(model)


def batch(cfg, dev, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2048))).to(
        dev)


def check_grad(dev) -> None:
    """One loss and backward at full width, 2 layers, through the kernels
    and through the plain attention."""
    from horovod_tpu_torch.models import LLAMA3_8B
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.training import next_token_loss

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model, named = lora_model(cfg, dev, seed=4, nonzero_b=True)
    tokens = batch(cfg, dev, seed=1)
    runs = []
    for ref in (False, True):
        model.zero_grad(set_to_none=True)
        registry.reset_launch_counts()
        loss = next_token_loss(model(tokens, force_reference=ref), tokens)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: p.grad.float().clone()
                                   for n, p in named},
                     registry.launch_counts()))
    (loss_k, g_k, c_k), (loss_r, g_r, c_r) = runs
    worst = max(((g_k[n] - g_r[n]).abs().max().item()
                 / max(g_r[n].abs().max().item(), 1e-30), n) for n in g_r)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    ok = (loss_rel <= 1e-2 and worst[0] <= BF16_TOL
          and all(torch.isfinite(g).all() for g in g_k.values())
          and all(c_k[f] == cfg.num_layers for f in
                  ("flash", "flash_bwd_dq", "flash_bwd_dkv"))
          and not any(c_r.values()))
    log({"phase": "grad", "layers": cfg.num_layers, "lora_rank": 8,
         "tensors": len(g_r), "loss": loss_k, "loss_plain": loss_r,
         "loss_rel_err": loss_rel, "worst_grad_rel_err": worst[0],
         "worst_grad": worst[1], "tol": BF16_TOL, "launches": c_k,
         "launches_plain": c_r, "ok": ok})
    if not ok:
        raise AssertionError("LoRA gradients through the kernels disagree "
                             "with the plain attention")
    del model, named, g_k, g_r


def lora_steps(hvd, cfg, dev, model, named, steps: int = 5) -> dict:
    """``broadcast_parameters`` -> ``DistributedOptimizer(AdamW,
    compression=bf16)`` -> ``make_train_step``, one warm-up and ``steps``
    timed steps on the 2 x 2048 batch of seed 0.  Returns the losses, the
    step times, the kernels' launches and the exchange over the timed
    steps, the peak memory from the warm-up's end, the planned buckets,
    and how many adapters changed and base tensors stayed bitwise."""
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import causal_lm_loss, make_train_step

    base = {n: p for n, p in model.named_parameters() if not p.requires_grad}
    base_host = {n: p.detach().to("cpu") for n, p in base.items()}
    lora_before = {n: p.detach().clone() for n, p in named}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3,
                          weight_decay=1e-4),
        named_parameters=named, compression=hvd.Compression.bf16)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_train_step(model, causal_lm_loss, opt)
    tokens = batch(cfg, dev, seed=0)

    losses = [step(tokens).item()]                  # warm-up
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(tokens).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    out = {"losses": losses, "step_ms": 1e3 * sum(times) / steps,
           "step_ms_each": [1e3 * x for x in times],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "exchange_per_step": {k: (v - before[k]) / steps
                                 for k, v in exchange_totals().items()},
           "plan_buckets": planned, "launches": counts,
           "lora_changed": sum(not torch.equal(p, lora_before[n])
                               for n, p in named),
           "lora_tensors": len(named),
           "base_unchanged": sum(torch.equal(p.detach().cpu(),
                                             base_host[n])
                                 for n, p in base.items()),
           "base_tensors": len(base)}
    out["tokens_per_s"] = 2 * 2048 / (out["step_ms"] / 1e3)
    del opt, step, base, base_host, lora_before
    return out


def lora_run_fails(run: dict, forwards: int, backwards: int) -> list:
    """Phase 6's checks on a :func:`lora_steps` run: finite, falling
    losses; every adapter changed, every base tensor bitwise the same;
    the attention kernels' launches a step; buckets and handles as
    planned."""
    fails, steps = [], len(run["step_ms_each"])
    losses, per_step = run["losses"], run["exchange_per_step"]
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if run["lora_changed"] != run["lora_tensors"]:
        fails.append(f"{run['lora_tensors'] - run['lora_changed']} LoRA "
                     "tensors unchanged")
    if run["base_unchanged"] != run["base_tensors"]:
        fails.append(f"{run['base_tensors'] - run['base_unchanged']} base "
                     "tensors changed")
    for f, n in (("flash", forwards), ("flash_bwd_dq", backwards),
                 ("flash_bwd_dkv", backwards)):
        if run["launches"][f] != n * steps:
            fails.append(f"{f} launches {run['launches'][f]} != "
                         f"{n} x {steps}")
    planned = run["plan_buckets"]
    if per_step["buckets"] != planned or per_step["handles"] != planned:
        fails.append(f"buckets/handles per step {per_step} != planned "
                     f"{planned}")
    return fails


def train_llama(dev, card: str) -> tuple:
    """Full-depth Llama-3 8B LoRA fine-tune through the port's Horovod
    path; returns the kernels' launch counts over the timed steps and
    the run's figures."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import LLAMA3_8B

    cfg, steps = LLAMA3_8B, 5
    hvd.init()
    t0 = time.perf_counter()
    model, named = lora_model(cfg, dev, seed=0, nonzero_b=False)
    torch.cuda.synchronize()
    log({"phase": "train_init", "config": "LLAMA3_8B",
         "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
         "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "base_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()
                           if not p.requires_grad),
         "trainable_tensors": len(named),
         "trainable_values": sum(p.numel() for _, p in named)})
    run = lora_steps(hvd, cfg, dev, model, named, steps)
    log({"phase": "train", "card": card, "steps": steps,
         "batch": [2, 2048], **run})
    fails = lora_run_fails(run, cfg.num_layers, cfg.num_layers)
    if fails:
        raise AssertionError("train: " + "; ".join(fails))
    hvd.shutdown()
    del model, named
    return run["launches"], run


# ---------------------------------------------------------------------------
# Phases 7-10: the ResNet-50 (plain and PowerSGD) and LeNet slices
# ---------------------------------------------------------------------------


RESNET50_BN_SITES = 53     # stem + 16 blocks x 3 + 4 projections
RESNET50_PARAM_TENSORS = 161
RESNET_F32_GRAD_TOL = 1e-3  # f32 roundoff through the 53-site backward,
                            # relative to max |plain grad|


def resnet50(dev, seed: int, dtype=torch.bfloat16):
    """ResNet-50 as ``bench.py`` times it (1000 classes, bf16 compute,
    space-to-depth stem) with flax-initialised random weights."""
    from horovod_tpu_torch.models import ResNet50, init_resnet_params
    model = ResNet50(num_classes=1000, dtype=dtype, space_to_depth=True,
                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.load_state_dict(init_resnet_params(model, generator=gen))
    return model, gen


def images(gen, dev, n: int, classes: int, side: int = 224) -> tuple:
    x = torch.randn(n, side, side, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, classes, (n,), generator=gen, device=dev)
    return x, y


def check_resnet_grad(dev) -> None:
    """One loss and backward of ResNet-50 at full width and depth on 32
    images, through the BN kernels and through their plain versions, in
    bf16 (the training configuration) and in f32 from the same weights.

    Every BN scale is drawn from N(1, 0.1), so no gradient is 0 by
    construction -- and every residual branch is live, which makes the
    backward chaotic: bf16 rounding alone moves most gradients by more
    than their size (bf16 plain against f32 plain).  So the kernels are
    held to f32 roundoff in f32 (``RESNET_F32_GRAD_TOL`` of each
    gradient's max |value|), and in bf16 to bf16's own noise: replacing
    the plain backward by the kernels must move no bf16 gradient by as
    much as bf16 moves it from f32.  The forward never touches a kernel,
    so both losses of a dtype are bitwise equal."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.ops.bn import BatchNorm
    from horovod_tpu_torch.training import softmax_xent

    model, gen = resnet50(dev, seed=5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.normal_(1.0, 0.1, generator=gen)
    x, y = images(gen, dev, 32, 1000)
    m32, _ = resnet50(dev, seed=5, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    runs = {}
    for dtype, mod in (("bf16", model), ("f32", m32)):
        for ref in (False, True):
            mod.zero_grad(set_to_none=True)
            registry.reset_launch_counts()
            loss = softmax_xent(mod(x, force_reference=ref), y)
            loss.backward()
            torch.cuda.synchronize()
            runs[dtype, ref] = (loss.item(), {
                n: p.grad.float().clone() for n, p in mod.named_parameters()},
                registry.launch_counts())

    def rel(a, b):
        return {n: (a[n] - b[n]).abs().max().item()
                / max(b[n].abs().max().item(), 1e-30) for n in b}

    e_bf16 = rel(runs["bf16", False][1], runs["bf16", True][1])
    e_f32 = rel(runs["f32", False][1], runs["f32", True][1])
    floor = rel(runs["bf16", True][1], runs["f32", True][1])
    want = RESNET50_BN_SITES
    counts_ok = all(
        runs[d, False][2]["bn_bwd_reduce"] == want
        and runs[d, False][2]["bn_bwd_dx"] == want
        and not any(runs[d, True][2].values()) for d in ("bf16", "f32"))
    losses_equal = all(runs[d, False][0] == runs[d, True][0]
                       for d in ("bf16", "f32"))
    worst_f32 = max((v, n) for n, v in e_f32.items())
    worst_bf16 = max((v, n) for n, v in e_bf16.items())
    margin = min((floor[n] / max(v, 1e-30), n) for n, v in e_bf16.items())
    ok = (losses_equal and counts_ok
          and len(e_f32) == RESNET50_PARAM_TENSORS
          and worst_f32[0] <= RESNET_F32_GRAD_TOL and margin[0] >= 1.0
          and all(torch.isfinite(g).all() for d in ("bf16", "f32")
                  for g in runs[d, False][1].values()))
    log({"phase": "resnet_grad", "config": "ResNet50 s2d",
         "batch": list(x.shape), "tensors": len(e_f32),
         "loss_bf16": runs["bf16", False][0],
         "loss_bf16_plain": runs["bf16", True][0],
         "loss_f32": runs["f32", False][0],
         "loss_f32_plain": runs["f32", True][0],
         "losses_bitwise_equal": losses_equal,
         "f32_worst_grad_rel_err": worst_f32[0], "f32_worst_grad":
             worst_f32[1], "f32_tol": RESNET_F32_GRAD_TOL,
         "bf16_worst_grad_rel_err": worst_bf16[0],
         "bf16_worst_grad": worst_bf16[1],
         "bf16_grads_over_2e-2": sum(v > BF16_TOL for v in e_bf16.values()),
         "bf16_vs_f32_median_rel_err": float(np.median(list(
             floor.values()))),
         "bf16_noise_margin": margin[0], "bf16_noise_margin_grad": margin[1],
         "launches": {d: runs[d, False][2] for d in ("bf16", "f32")},
         "launches_plain": {d: runs[d, True][2] for d in ("bf16", "f32")},
         "ok": ok})
    if not ok:
        raise AssertionError("ResNet-50 gradients through the BN kernels "
                             "disagree with the plain backward")
    del model, m32, runs


def train_resnet(dev, card: str) -> dict:
    """``bench.py``'s ResNet-50 configuration through the port's Horovod
    path: 256 images of 224 x 224, one warm-up and five timed steps;
    returns the kernels' launch counts over the timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import make_flax_train_step

    batch_size, steps = 256, 5
    hvd.init()
    t0 = time.perf_counter()
    model, _ = resnet50(dev, seed=0)
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=hvd.Compression.none)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_flax_train_step(model, opt)
    batch = images(torch.Generator(device=dev).manual_seed(0), dev,
                   batch_size, 1000)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    before_s = {n: b.clone() for n, b in model.named_buffers()}
    log({"phase": "resnet_init", "config": "ResNet50 s2d bf16",
         "seconds": time.perf_counter() - t0, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "param_tensors": len(named),
         "param_values": sum(p.numel() for _, p in named),
         "bn_sites": RESNET50_BN_SITES})

    losses = [step(batch).item()]                  # warm-up
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    stats = dict(model.named_buffers())
    stats_moved = sum(not torch.equal(b, before_s[n])
                      and bool(torch.isfinite(b).all())
                      for n, b in stats.items())
    log({"phase": "resnet_train", "card": card, "steps": steps,
         "batch": list(batch[0].shape), "losses": losses,
         "step_ms": step_ms, "step_ms_each": [1e3 * t for t in times],
         "images_per_s": batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "params_changed": changed, "param_tensors": len(named),
         "stats_changed_finite": stats_moved, "stat_tensors": len(stats)})
    want = RESNET50_BN_SITES * steps
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named):
        fails.append(f"{len(named) - changed} parameters unchanged")
    if stats_moved != len(stats):
        fails.append(f"{len(stats) - stats_moved} running statistics "
                     f"unchanged or not finite")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != want:
            fails.append(f"{f} launches {counts[f]} != {want}")
    if per_step["buckets"] != planned or per_step["handles"] != planned:
        fails.append(f"buckets/handles per step {per_step} != planned "
                     f"{planned}")
    if fails:
        raise AssertionError("resnet_train: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, opt, step, batch, before_p, before_s, stats
    counts = dict(counts, step_ms=step_ms)
    return counts


def train_resnet_powersgd(dev, card: str) -> dict:
    """``resnet_train``'s configuration with ``compression="powersgd:4"``:
    the rank-4 PowerSGD exchange with error feedback, each bucket through
    the three fused_update kernels and two factor allreduces.  The first
    (warm-up) step's real buckets are exchanged again through the plain
    versions and compared; returns the kernels' launch counts over the
    five timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.compression import wire_payload_bytes
    from horovod_tpu_torch.collectives.ops import powersgd_allreduce
    from horovod_tpu_torch.ops import fused_update as fu
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import (exchange_totals,
                                                    registry as metrics)
    from horovod_tpu_torch.training import make_flax_train_step

    batch_size, steps = 256, 5
    hvd.init()
    t0 = time.perf_counter()
    model, _ = resnet50(dev, seed=0)
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=f"powersgd:{POWERSGD_RANK}")
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_flax_train_step(model, opt)
    batch = images(torch.Generator(device=dev).manual_seed(0), dev,
                   batch_size, 1000)
    sizes = [sum(s.size for s in lspecs)
             for _, lspecs in opt.bucket_plan.buffers]
    wire = sum(wire_payload_bytes(opt._compression, n) for n in sizes)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    log({"phase": "resnet_powersgd_init", "config": "ResNet50 s2d bf16",
         "compression": opt._compression.__name__,
         "seconds": time.perf_counter() - t0, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "bucket_values": sizes,
         "bucket_leaves": [len(l) for _, l in opt.bucket_plan.buffers],
         "wire_bytes_per_step": wire,
         "compression_ratio": metrics().gauge(
             "horovod_compression_ratio").value})

    # The warm-up step, with every exchange's stage-1 inputs and stage-3
    # outputs recorded (paired through their acc arena).
    seen = []
    real_mp, real_rr = fu.matricize_p, fu.reconstruct_residual

    def matricize_p(x, residual, q0, **kw):
        acc, p = real_mp(x, residual, q0, **kw)
        # The residual is updated in place after the exchange: keep the
        # one this exchange read.
        kept = None if residual is None else residual.clone()
        seen.append({"acc": acc, "x": x, "residual": kept})
        return acc, p

    def reconstruct_residual(acc, *args, **kw):
        out = real_rr(acc, *args, **kw)
        next(e for e in seen if e["acc"] is acc)["got"] = out
        return out

    fu.matricize_p, fu.reconstruct_residual = (matricize_p,
                                               reconstruct_residual)
    try:
        losses = [step(batch).item()]
    finally:
        fu.matricize_p, fu.reconstruct_residual = real_mp, real_rr
    first = []
    for e in seen:
        want = powersgd_allreduce(e["x"], hvd.Average, rank=POWERSGD_RANK,
                                  residual=e["residual"],
                                  force_reference=True)
        errs = [(g - w).abs().max().item() for g, w in zip(e["got"], want)]
        tols = [POWERSGD_STEP_TOL * w.abs().max().item() for w in want]
        first.append({"size": e["x"].numel(), "out_err": errs[0],
                      "out_tol": tols[0], "residual_err": errs[1],
                      "residual_tol": tols[1],
                      "ok": all(a <= b for a, b in zip(errs, tols))})
    del seen

    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    residuals = [{"values": r.numel(), "finite": bool(torch.isfinite(r).all()),
                  "max_abs": r.abs().max().item()} for r in opt.residuals]
    log({"phase": "resnet_powersgd", "card": card, "steps": steps,
         "batch": list(batch[0].shape), "losses": losses,
         "step_ms": step_ms, "step_ms_each": [1e3 * t for t in times],
         "images_per_s": batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "launches": counts, "params_changed": changed,
         "param_tensors": len(named), "residuals": residuals,
         "first_step_exchange": first})
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named) or len(named) != RESNET50_PARAM_TENSORS:
        fails.append(f"{changed} of {len(named)} parameters changed")
    if not all(r["finite"] and r["max_abs"] > 0 for r in residuals):
        fails.append(f"a residual is zero or not finite: {residuals}")
    if sizes != list(POWERSGD_BUCKETS) or wire != POWERSGD_WIRE_BYTES:
        fails.append(f"EF plan {sizes}, {wire} wire bytes")
    nb = len(POWERSGD_BUCKETS)
    if per_step != {"buckets": nb, "wire_bytes": POWERSGD_WIRE_BYTES,
                    "handles": 2 * nb}:
        fails.append(f"exchange per step {per_step}")
    for f in ("fused_update_matricize_p", "fused_update_orthonormalize_q",
              "fused_update_reconstruct"):
        if counts[f] != nb * steps:
            fails.append(f"{f} launches {counts[f]} != {nb * steps}")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != RESNET50_BN_SITES * steps:
            fails.append(f"{f} launches {counts[f]}")
    if len(first) != nb or not all(e["ok"] for e in first):
        fails.append(f"first step's exchange vs plain: {first}")
    if fails:
        raise AssertionError("resnet_powersgd: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, opt, step, batch, before_p
    return counts


def train_lenet(dev) -> None:
    """A few LeNet steps on a synthetic MNIST-like batch (10 gaussian
    centers, as ``examples/mnist_lenet.py``) with that example's
    optimizer, SGD(0.01, momentum 0.9), through the same step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import LeNet, init_params
    from horovod_tpu_torch.training import make_flax_train_step

    hvd.init()
    model = LeNet(device=dev)
    model.load_state_dict(init_params(
        model, generator=torch.Generator(device=dev).manual_seed(0)))
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.01, momentum=0.9),
        named_parameters=named)
    step = make_flax_train_step(model, opt)
    rng = np.random.RandomState(42)
    centers = rng.randn(10, 28 * 28).astype(np.float32)
    y = rng.randint(0, 10, size=256)
    x = centers[y] + 0.5 * rng.randn(256, 28 * 28).astype(np.float32)
    batch = (torch.from_numpy(x.reshape(-1, 28, 28, 1)).to(dev),
             torch.from_numpy(y).to(dev))
    losses = [step(batch).item() for _ in range(10)]
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    log({"phase": "lenet", "batch": [256, 28, 28, 1], "losses": losses,
         "ok": ok})
    if not ok:
        raise AssertionError(f"lenet: the loss did not fall: {losses}")
    hvd.shutdown()


# ---------------------------------------------------------------------------
# Phases 11-12: BERT-Large pretraining with Adasum and fp16 compression
# ---------------------------------------------------------------------------


BERT_LARGE_TENSORS = 399
BERT_LARGE_VALUES = 336_197_634   # jax.eval_shape of the flax Bert init
BERT_WIRE_BYTES = 2 * BERT_LARGE_VALUES   # fp16 on the wire, every bucket


def bert_model(cfg, dev, seed: int):
    from horovod_tpu_torch.models import Bert, init_bert_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Bert.from_params(cfg, init_bert_params(cfg, generator=gen,
                                                  device=dev),
                            dtype=torch.bfloat16)


def bert_batch(cfg, dev, b: int, t: int, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (b, t))
    nsp = rng.randint(0, 2, (b,))
    return (torch.from_numpy(tokens).to(dev), torch.from_numpy(nsp).to(dev))


def check_bert_grad(dev) -> None:
    """One loss and backward of BERT at BERT-Large's width, 2 layers, bf16,
    on 4 x 512 tokens packed with two segments a row, through the
    attention kernels and through the plain attention.  ``wk.bias``'s
    gradient is zero in exact arithmetic (a key bias shifts every logit of
    a query alike), so both runs hold roundoff there: its difference is
    held to the same bound relative to its layer's ``wk.kernel``
    gradient, the sum over the same tokens that carries its scale.  As
    information, both bf16 runs against the same model in f32 through the
    plain attention: how far each path is from the f32 gradients."""
    from horovod_tpu_torch.models import BERT_LARGE, Bert
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.training import mlm_nsp_loss

    cfg = dataclasses.replace(BERT_LARGE, num_layers=2)
    model = bert_model(cfg, dev, seed=8)
    tokens, nsp = bert_batch(cfg, dev, 4, 512, seed=2)
    seg = bert_segments(4, 512, dev)
    runs = []
    for ref in (False, True):
        model.zero_grad(set_to_none=True)
        registry.reset_launch_counts()
        mlm, nsp_logits = model(tokens, pack_segment_ids=seg,
                                force_reference=ref)
        loss = mlm_nsp_loss(mlm, nsp_logits, tokens, nsp)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: p.grad.float().clone()
                                   for n, p in model.named_parameters()},
                     registry.launch_counts()))
        del mlm, nsp_logits, loss
    (loss_k, g_k, c_k), (loss_r, g_r, c_r) = runs
    m32 = Bert.from_params(cfg, {n: t.detach().clone() for n, t in
                                 model.state_dict().items()})
    mlm, nsp_logits = m32(tokens, pack_segment_ids=seg, force_reference=True)
    mlm_nsp_loss(mlm, nsp_logits, tokens, nsp).backward()
    g_32 = {n: p.grad for n, p in m32.named_parameters()}
    del mlm, nsp_logits

    def scale(g, n):
        if n.endswith(".wk.bias"):
            n = n[:-len("bias")] + "kernel"
        return max(g[n].abs().max().item(), 1e-30)

    def worst_of(a, b):
        return max(((a[n] - b[n]).abs().max().item() / scale(b, n), n)
                   for n in b)

    worst = worst_of(g_k, g_r)
    vs_f32 = {"kernels": worst_of(g_k, g_32), "plain": worst_of(g_r, g_32)}
    del m32, g_32
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    ok = (loss_rel <= 1e-2 and worst[0] <= BF16_TOL
          and all(torch.isfinite(g).all() for g in g_k.values())
          and all(c_k[f] == cfg.num_layers for f in
                  ("flash", "flash_bwd_dq", "flash_bwd_dkv"))
          and not any(c_r.values()))
    log({"phase": "bert_grad", "layers": cfg.num_layers,
         "batch": list(tokens.shape), "segments_per_row": 2,
         "tensors": len(g_r), "loss": loss_k, "loss_plain": loss_r,
         "loss_rel_err": loss_rel, "worst_grad_rel_err": worst[0],
         "worst_grad": worst[1], "tol": BF16_TOL,
         "worst_grad_rel_err_vs_f32": {k: v[0] for k, v in vs_f32.items()},
         "worst_grad_vs_f32": {k: v[1] for k, v in vs_f32.items()},
         "launches": c_k, "launches_plain": c_r, "ok": ok})
    if not ok:
        raise AssertionError("BERT gradients through the kernels disagree "
                             "with the plain attention")
    del model, g_k, g_r


BERT_EXTRA_STEPS = 4   # untimed, after the timed ones: see train_bert


def bert_trainer(cfg, dev, plain: bool = False):
    """``(step, model, named, opt)``: BERT at ``cfg`` from seed 0, bf16,
    ``DistributedAdasumOptimizer(AdamW(lr 1e-3, weight_decay 1e-4),
    compression=fp16)`` (``examples/bert_pretrain.py``'s defaults) and
    ``make_train_step``; ``plain`` runs attention through the plain
    version instead of the kernels."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import (bert_pretrain_loss,
                                            make_train_step, mlm_nsp_loss)
    model = bert_model(cfg, dev, seed=0)
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedAdasumOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3, weight_decay=1e-4),
        named_parameters=named, compression=hvd.Compression.fp16)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    def plain_loss(m, b):
        return mlm_nsp_loss(*m(b[0], force_reference=True), *b)

    step = make_train_step(model, plain_loss if plain else
                           bert_pretrain_loss, opt)
    return step, model, named, opt


def train_bert(dev, card: str) -> dict:
    """BERT-Large MLM + NSP pretraining through the port's Adasum path
    (``examples/bert_pretrain.py --large``): full width and depth, bf16
    compute, 64 x 128 tokens, ``DistributedAdasumOptimizer(AdamW,
    compression=fp16)``, one warm-up and five timed steps.  In the
    warm-up step every bucket's packed gradient is recorded with its
    reduced result: at world 1 Adasum is the identity, so the result must
    be the packed gradient's fp16 round trip, bitwise.

    AdamW at lr 1e-3 with no learning-rate warm-up first drives the loss
    up (every weight moves by ~lr in its gradient's sign at once) and
    then down, through the plain attention as through the kernels; so
    ``BERT_EXTRA_STEPS`` untimed steps follow the timed ones, and the loss
    must end below where it started.  The same ten steps through the
    plain attention, from the same weights, are logged beside them.
    Returns the kernels' launch counts over the timed steps, with the
    step ms (``step_ms``)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.models import BERT_LARGE, flax_leaf_order
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.optim import distributed
    from horovod_tpu_torch.timeline.metrics import exchange_totals

    cfg, (b, t), steps = BERT_LARGE, (64, 128), 5
    hvd.init()
    t0 = time.perf_counter()
    step, model, named, opt = bert_trainer(cfg, dev)
    batch = bert_batch(cfg, dev, b, t, seed=0)
    # The JAX flat exchange's plan: forward over jax.tree.leaves order.
    order = flax_leaf_order([n for n, _ in named])
    planned = len(plan_buckets([named[i][1] for i in order],
                               64 * 1024 * 1024).buffers)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    tensors, values = len(named), sum(p.numel() for _, p in named)
    compression = opt._compression.__name__
    log({"phase": "bert_init", "config": "BERT_LARGE",
         "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
         "world": hvd.size(), "backend": torch.distributed.get_backend(),
         "param_tensors": tensors, "param_values": values,
         "buckets": len(opt.bucket_plan.buffers),
         "bucket_bytes": opt.bucket_plan.bucket_bytes()})

    packed, reduced = [], []
    real_pack, real_unpack = distributed.pack_bucket, distributed.unpack_bucket

    def pack_bucket(leaves, lspecs):
        buf = real_pack(leaves, lspecs)
        packed.append(buf.clone())
        return buf

    def unpack_bucket(buf, lspecs):
        reduced.append(buf)
        return real_unpack(buf, lspecs)

    distributed.pack_bucket, distributed.unpack_bucket = (pack_bucket,
                                                          unpack_bucket)
    try:
        losses = [step(batch).item()]               # warm-up
    finally:
        distributed.pack_bucket, distributed.unpack_bucket = (real_pack,
                                                              real_unpack)
    identity = len(packed) == len(reduced) == planned and all(
        torch.equal(r, p.half().float()) for p, r in zip(packed, reduced))
    del packed, reduced

    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t1)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    losses += [step(batch).item() for _ in range(BERT_EXTRA_STEPS)]
    del model, named, opt, step, before_p
    free_device()
    step, *_ = bert_trainer(cfg, dev, plain=True)
    plain = [step(batch).item() for _ in losses]
    del step
    log({"phase": "bert_train", "card": card, "steps": steps,
         "batch": [b, t], "compression": compression,
         "losses": losses, "losses_plain_attention": plain,
         "step_ms": step_ms,
         "step_ms_each": [1e3 * x for x in times],
         "sequences_per_s": b / (step_ms / 1e3),
         "tokens_per_s": b * t / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "params_changed": changed, "param_tensors": tensors,
         "warmup_exchange_is_fp16_round_trip": identity})
    want = cfg.num_layers * steps
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if (tensors, values) != (BERT_LARGE_TENSORS, BERT_LARGE_VALUES):
        fails.append(f"{tensors} tensors of {values} values, not "
                     f"{BERT_LARGE_TENSORS} of {BERT_LARGE_VALUES}")
    if changed != tensors:
        fails.append(f"{tensors - changed} parameters unchanged")
    for f in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[f] != want:
            fails.append(f"{f} launches {counts[f]} != {want}")
    if per_step != {"buckets": planned, "wire_bytes": BERT_WIRE_BYTES,
                    "handles": planned}:
        fails.append(f"exchange per step {per_step}, planned {planned} "
                     f"buckets and {BERT_WIRE_BYTES} wire bytes")
    if not identity:
        fails.append("the warm-up exchange is not the fp16 round trip")
    if fails:
        raise AssertionError("bert_train: " + "; ".join(fails))
    hvd.shutdown()
    return dict(counts, step_ms=step_ms)


# ---------------------------------------------------------------------------
# Phases 13-15: sync BN, Inception-v3 and VGG-16 (after BERT, before the
# profiler of phase 16)
# ---------------------------------------------------------------------------


# sync_batch_norm against the plain layer at ResNet-50's widest BN site and
# Inception's second stem site (NHWC, bf16, batch 256 and 32); the
# torch-style layer at Inception's stem width after the third conv
# (channels_last NCHW, bf16); pass 2 with the sums of four ranks.
BN_SYNC_CASES = ((256, 56, 56, 256), (32, 147, 147, 32))
SYNC_BN_TORCH_SHAPE = (32, 64, 147, 147)
BN_COUNT_CASE = (2048, 192, 4)          # rows, channels, ranks summed
INCEPTION_BN_SITES = 94
VGG16_VALUES = 138_357_544              # jax.eval_shape of the flax VGG16
VGG16_WIRE_BYTES = 4 * VGG16_VALUES     # f32 on the wire, uncompressed


def _bn_step(m, x, dy, ref: bool = False) -> tuple:
    """One train-mode forward and backward of ``m`` on ``x``:
    ``(y, dx, dscale, dbias)``."""
    m.zero_grad(set_to_none=True)
    xt = x.detach().requires_grad_(True)
    y = m(xt, force_reference=ref) if ref else m(xt)
    y.backward(dy)
    grads = [p.grad for p in m.parameters()]
    return (y.detach(), xt.grad, *grads)


def _rel_errs(got, want) -> list:
    return [(g.float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for g, w in zip(got, want)]


def check_bn_sync(dev, card: str) -> None:
    """Synchronized BatchNorm at world 1 on the card, as information and
    check (5 warm-up and 20 timed forward + backward steps each):

    * ``sync_batch_norm`` against the plain ``ops.bn.BatchNorm``: output,
      running statistics, dx, dgamma and dbeta bitwise equal (at world 1
      both allreduces are identities), one launch of each BN kernel and
      two allreduces a step; both within the BN bounds of phase 3 of the
      backward through the plain versions;
    * ``hvd.SyncBatchNorm`` on a channels_last bf16 input against the
      plain PyTorch layer (autograd of the f32 formula), no layout copy,
      timed beside cuDNN's ``BatchNorm2d`` (the library yardstick);
    * ``bn_backward_dx`` with ``count`` four times the rows (sums of four
      ranks) against its plain version."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import bn, registry
    from horovod_tpu_torch.timeline.metrics import sync_bn_totals
    from horovod_tpu_torch.training import sync_batch_norm

    hvd.init()
    gen = torch.Generator(device=dev).manual_seed(9)
    fails, cases = [], []
    for shape in BN_SYNC_CASES:
        c = shape[-1]
        x = (2.0 * torch.randn(*shape, generator=gen, device=dev)
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)
        state = {"scale": 1.0 + 0.1 * torch.randn(c, generator=gen,
                                                  device=dev),
                 "bias": 0.1 * torch.randn(c, generator=gen, device=dev),
                 "mean": torch.zeros(c, device=dev),
                 "var": torch.ones(c, device=dev)}
        sync = sync_batch_norm(features=c, momentum=0.9,
                               dtype=torch.bfloat16, device=dev)
        plain = bn.BatchNorm(c, momentum=0.9, dtype=torch.bfloat16,
                             device=dev)
        runs = {}
        for name, m, ref in (("sync", sync, False), ("plain", plain, False),
                             ("reference", plain, True)):
            m.load_state_dict(state)
            registry.reset_launch_counts()
            before = sync_bn_totals()["allreduces"]
            out = _bn_step(m, x, dy, ref)
            torch.cuda.synchronize()
            runs[name] = (out, (m.mean.clone(), m.var.clone()),
                          registry.launch_counts(),
                          sync_bn_totals()["allreduces"] - before)
        bitwise = all(torch.equal(a, b) for a, b in zip(
            runs["sync"][0] + runs["sync"][1],
            runs["plain"][0] + runs["plain"][1]))
        errs = _rel_errs(runs["sync"][0][1:], runs["reference"][0][1:])
        tols = (BF16_TOL, BN_SUM_TOL, BN_SUM_TOL)
        launches = {k: runs["sync"][2][k] for k in ("bn_bwd_reduce",
                                                    "bn_bwd_dx")}
        ms = {name: time_ms(lambda m=m: _bn_step(m, x, dy), reps=20,
                            warmup=5) for name, m in (("sync", sync),
                                                      ("plain", plain))}
        rec = {"shape": list(shape), "dtype": "bfloat16",
               "bitwise_equal_at_world_1": bitwise,
               "rel_err_vs_plain_backward": dict(zip(
                   ("dx", "dgamma", "dbeta"), errs)),
               "tol": dict(zip(("dx", "dgamma", "dbeta"), tols)),
               "launches": launches,
               "sync_allreduces": runs["sync"][3],
               "step_ms": ms}
        cases.append(rec)
        if not bitwise:
            fails.append(f"{shape}: sync and plain layers differ at world 1")
        if any(e > t for e, t in zip(errs, tols)):
            fails.append(f"{shape}: sync vs plain backward {errs}")
        if launches != {"bn_bwd_reduce": 1, "bn_bwd_dx": 1}:
            fails.append(f"{shape}: launches {launches}")
        if runs["sync"][3] != 2 or runs["plain"][3] != 0:
            fails.append(f"{shape}: sync allreduces {runs['sync'][3]}")
        del x, dy, runs, sync, plain
        free_device()
    torch_rec = check_hvd_sync_batch_norm(dev, gen, fails)
    count_rec = check_bn_dx_count(bn, dev, gen, fails)
    log({"phase": "bn_sync", "card": card, "world": hvd.size(),
         "sync_batch_norm": cases, "hvd_SyncBatchNorm": torch_rec,
         "bn_backward_dx_count": count_rec, "ok": not fails})
    if fails:
        raise AssertionError("bn_sync: " + "; ".join(fails))
    hvd.shutdown()


def check_hvd_sync_batch_norm(dev, gen, fails: list) -> dict:
    """``hvd.SyncBatchNorm`` on ``SYNC_BN_TORCH_SHAPE`` channels_last bf16
    against autograd of the f32 formula, timed beside cuDNN."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import sync_bn_totals

    n, c, h, w = SYNC_BN_TORCH_SHAPE
    cl = dict(memory_format=torch.channels_last)
    x = (2.0 * torch.randn(n, c, h, w, generator=gen, device=dev)
         + 0.5).to(torch.bfloat16).contiguous(**cl)
    dy = torch.randn(n, c, h, w, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(**cl)
    m = hvd.SyncBatchNorm(c, momentum=0.1, device=dev)
    with torch.no_grad():
        m.weight.normal_(1.0, 0.1, generator=gen)
        m.bias.normal_(0.0, 0.1, generator=gen)
    eps, dims = m.eps, (0, 2, 3)

    def layer():
        m.zero_grad(set_to_none=True)
        xt = x.detach().requires_grad_(True)
        y = m(xt)
        y.backward(dy)
        return y.detach(), xt.grad, m.weight.grad, m.bias.grad

    def reference():
        xt = x.detach().float().requires_grad_(True)
        wt = m.weight.detach().clone().requires_grad_(True)
        bt = m.bias.detach().clone().requires_grad_(True)
        mean = xt.mean(dims, keepdim=True)
        var = (xt.square().mean(dims, keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = ((xt - mean) * torch.rsqrt(var + eps) * wt.view(1, c, 1, 1)
             + bt.view(1, c, 1, 1))
        y.backward(dy.float())
        return y.detach(), xt.grad, wt.grad, bt.grad

    before = sync_bn_totals()
    registry.reset_launch_counts()
    got = layer()
    counts = registry.launch_counts()
    moved = {k: v - before[k] for k, v in sync_bn_totals().items()}
    want = reference()
    torch.cuda.synchronize()
    errs = _rel_errs(got, want)
    tols = (BF16_TOL, BF16_TOL, BN_SUM_TOL, BN_SUM_TOL)
    ms = time_ms(layer, reps=20, warmup=5)
    plain_ms = time_ms(reference, reps=20, warmup=5)
    lib = torch.nn.BatchNorm2d(c, device=dev)
    lib.load_state_dict(m.state_dict())
    lib_dtype = "bfloat16"

    def library(xl, dyl):
        def run():
            lib.zero_grad(set_to_none=True)
            xt = xl.detach().requires_grad_(True)
            lib(xt).backward(dyl)
        return run
    try:
        lib_ms = time_ms(library(x, dy), reps=20, warmup=5)
    except RuntimeError:
        lib_dtype = "float32"
        lib_ms = time_ms(library(x.float().contiguous(**cl),
                                 dy.float().contiguous(**cl)),
                         reps=20, warmup=5)
    launches = {k: counts[k] for k in ("bn_bwd_reduce", "bn_bwd_dx")}
    rec = {"shape": list(SYNC_BN_TORCH_SHAPE), "layout": "channels_last",
           "dtype": "bfloat16",
           "rel_err_vs_plain": dict(zip(("y", "dx", "dweight", "dbias"),
                                        errs)),
           "tol": dict(zip(("y", "dx", "dweight", "dbias"), tols)),
           "launches": launches, "sync_bn_counters": moved,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": f"torch.nn.BatchNorm2d (cuDNN), {lib_dtype}"}
    if any(e > t for e, t in zip(errs, tols)):
        fails.append(f"SyncBatchNorm vs plain {errs}")
    if launches != {"bn_bwd_reduce": 1, "bn_bwd_dx": 1}:
        fails.append(f"SyncBatchNorm launches {launches}")
    if moved["allreduces"] != 2 or moved["layout_copies"] != 0:
        fails.append(f"SyncBatchNorm counters {moved}")
    del x, dy, got, want, m, lib
    free_device()
    return rec


def check_bn_dx_count(bn, dev, gen, fails: list) -> dict:
    """Pass 2 with sums of ``ranks`` ranks and the global count, kernel
    against plain."""
    rows, c, ranks = BN_COUNT_CASE
    x = (2.0 * torch.randn(rows, c, generator=gen, device=dev)
         + 0.5).to(torch.bfloat16)
    dy = torch.randn(rows, c, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    mean, var = bn.batch_stats(x)
    inv = torch.rsqrt(var + 1e-3)
    dbeta, dgamma = bn.bn_backward_reduce(x, dy, mean, inv)
    sums = [s * ranks + torch.randn(c, generator=gen, device=dev)
            for s in (dbeta, dgamma)]
    count = rows * ranks
    got = bn.bn_backward_dx(x, dy, mean, inv, scale, *sums, count=count)
    want = bn.bn_backward_dx(x, dy, mean, inv, scale, *sums, count=count,
                             force_reference=True)
    local = bn.bn_backward_dx(x, dy, mean, inv, scale, *sums)
    torch.cuda.synchronize()
    err = _rel_errs([got], [want])[0]
    apart = _rel_errs([local], [want])[0]
    rec = {"rows": rows, "c": c, "count": count, "dtype": "bfloat16",
           "rel_err": err, "tol": BF16_TOL,
           "rel_diff_of_count_rows": apart}
    if not err <= BF16_TOL or not apart > BF16_TOL:
        fails.append(f"bn_backward_dx(count={count}): {rec}")
    return rec


def train_cnn(phase: str, name: str, dev, card: str, sites: int) -> dict:
    """``name`` through the synthetic benchmark's own setup
    (``horovod_tpu_torch.synthetic_benchmark.setup``: batch 32 at the
    model's image size, bf16, 1000 classes, ``DistributedOptimizer(
    SGD(0.01, momentum 0.9))``, dropout 0): one warm-up and five timed
    steps.  Losses finite and falling, every parameter and running
    statistic changed and finite, ``sites`` launches of each BN kernel a
    step, the planned buckets, one handle each and every f32 gradient's
    4 bytes on the wire a step.  Returns the launch counts over the
    timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import exchange_totals

    steps, batch_size = 5, 32
    hvd.init()
    t0 = time.perf_counter()
    bench = sb.setup(name, batch_size=batch_size)
    model, step = bench.model, bench.step
    named = list(model.named_parameters())
    values = sum(p.numel() for _, p in named)
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    before_s = {n: b.clone() for n, b in model.named_buffers()}
    log({"phase": f"{phase}_init", "model": name,
         "seconds": time.perf_counter() - t0, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "image_size": bench.image_size, "param_tensors": len(named),
         "param_values": values, "bn_sites": sites,
         "bucket_bytes": bench.optimizer.bucket_plan.bucket_bytes()})

    losses = [step(bench.batch).item()]            # warm-up
    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(bench.batch).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    stats = dict(model.named_buffers())
    stats_moved = sum(not torch.equal(b, before_s[n])
                      and bool(torch.isfinite(b).all())
                      for n, b in stats.items())
    log({"phase": phase, "card": card, "steps": steps,
         "batch": list(bench.batch[0].shape), "losses": losses,
         "step_ms": step_ms, "step_ms_each": [1e3 * t for t in times],
         "images_per_s": batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "params_changed": changed, "param_tensors": len(named),
         "stats_changed_finite": stats_moved, "stat_tensors": len(stats)})
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named):
        fails.append(f"{len(named) - changed} parameters unchanged")
    if stats_moved != len(stats):
        fails.append(f"{len(stats) - stats_moved} running statistics "
                     f"unchanged or not finite")
    for f, n in counts.items():
        want = sites * steps if f in ("bn_bwd_reduce", "bn_bwd_dx") else 0
        if n != want:
            fails.append(f"{f} launches {n} != {want}")
    if per_step != {"buckets": planned, "wire_bytes": 4 * values,
                    "handles": planned}:
        fails.append(f"exchange per step {per_step}, planned {planned} "
                     f"buckets and {4 * values} wire bytes")
    if name == "vgg16" and 4 * values != VGG16_WIRE_BYTES:
        fails.append(f"VGG-16 has {values} values, not {VGG16_VALUES}")
    if fails:
        raise AssertionError(f"{phase}: " + "; ".join(fails))
    hvd.shutdown()
    del model, step, bench, named, before_p, before_s, stats
    return counts


TORCH_API_BYTES = 64 * 1024 * 1024       # the timed buffer: 64 MiB of f32
TORCH_MNIST_STEPS = 30
TORCH_RN50_VALUES = 25_557_032           # the torch-idiom ResNet-50
TORCH_RN50_TENSORS = 161
TORCH_RN50_WIRE_BYTES = 2 * TORCH_RN50_VALUES   # fp16 on the wire


def _exact(fails: list, what: str, got, want) -> None:
    """``got`` equal to ``want`` bitwise (tensors, lists of them, or
    anything ``==`` compares)."""
    if torch.is_tensor(want):
        same = (torch.is_tensor(got) and got.shape == want.shape
                and got.dtype == want.dtype and torch.equal(got, want))
    elif isinstance(want, (list, tuple)) and want and \
            torch.is_tensor(want[0]):
        same = len(got) == len(want) and all(
            g.shape == w.shape and torch.equal(g, w)
            for g, w in zip(got, want))
    else:
        same = got == want
    if not same:
        fails.append(what)


def check_torch_api(dev, card: str) -> None:
    """The ``horovod.torch`` surface on NCCL at world 1, on the global set
    and on ``add_process_set([0])``: every op held to its definition
    exactly (at world 1 each is an identity or a slice), then each timed
    on a 64 MiB f32 buffer (CUDA events, 10 calls after 2)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.adasum.vhdd import adasum_allreduce_hierarchical
    from horovod_tpu_torch.timeline.metrics import collective_totals

    hvd.init()
    one = hvd.add_process_set([0])
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(64, 48, generator=gen, device=dev)
    xi = torch.randint(-50, 50, (64, 48), generator=gen, device=dev,
                       dtype=torch.int32)
    fails, ops_checked = [], 0
    for name, ps in (("global", None), ("one_member", one)):
        kw = dict(process_set=ps)
        for t in (x, xi):
            for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max,
                       hvd.Product):
                _exact(fails, f"{name} reducescatter {op} {t.dtype}",
                       hvd.reducescatter(t, op=op, **kw), t)
                _exact(fails, f"{name} reducescatter axis 1 {op}",
                       hvd.reducescatter(t, op=op, scatter_axis=1, **kw), t)
                _exact(fails, f"{name} allreduce {op} {t.dtype}",
                       hvd.allreduce(t, op=op, **kw), t)
                ops_checked += 3
        _exact(fails, f"{name} alltoall", hvd.alltoall(x, **kw), x)
        got, splits = hvd.alltoall(x, splits=[64], **kw)
        _exact(fails, f"{name} alltoall splits", got, x)
        _exact(fails, f"{name} alltoall received splits", splits.tolist(),
               [64])
        _exact(fails, f"{name} grouped_allgather",
               hvd.grouped_allgather([x, xi[:5]], **kw), [x, xi[:5]])
        _exact(fails, f"{name} grouped_reducescatter",
               hvd.grouped_reducescatter([x, x[:8]], op=hvd.Sum, **kw),
               [x, x[:8]])
        sp = (x * (x > 1.0)).to_sparse()
        for op in (hvd.Sum, hvd.Average):
            got = hvd.synchronize(hvd.sparse_allreduce_async(sp, op=op,
                                                             **kw))
            _exact(fails, f"{name} sparse_allreduce {op}", got.to_dense(),
                   sp.to_dense())
        _exact(fails, f"{name} allgather_object",
               hvd.allgather_object({"rank": 0, "set": name}, **kw),
               [{"rank": 0, "set": name}])
        _exact(fails, f"{name} Adasum",
               hvd.allreduce(x, op=hvd.Adasum, **kw), x)
        h = hvd.allreduce_async(x, op=hvd.Sum, **kw)
        _exact(fails, f"{name} handle", hvd.synchronize(h), x)
        try:
            hvd.poll(h)
            fails.append(f"{name}: a spent handle polled")
        except ValueError:
            pass
        hg = hvd.grouped_allreduce_async([x, xi], op=hvd.Sum, **kw)
        deadline = time.monotonic() + 60
        while not hvd.poll(hg):
            if time.monotonic() > deadline:
                fails.append(f"{name}: poll never turned true")
                break
        _exact(fails, f"{name} grouped handle", hvd.synchronize(hg),
               [x, xi])
        hvd.barrier(**kw)
        ops_checked += 14
    _exact(fails, "hierarchical Adasum (local_size 1)",
           adasum_allreduce_hierarchical(x, local_size=1), x)
    torch.cuda.synchronize()

    big = torch.randn(TORCH_API_BYTES // 4, generator=gen, device=dev)
    rows = big.view(-1, 1024)
    # The exchanges of the compressed paths on the same 64 MiB: at world
    # 1 the chunked allreduce is the allreduce (as in the reference), the
    # fp8 one the round trip quantize, dequantize, quantize, dequantize.
    chunk = TORCH_API_BYTES // 16
    _exact(fails, "chunked_allreduce",
           hvd.collective_ops.chunked_allreduce(big, hvd.Sum,
                                                chunk_bytes=chunk),
           hvd.allreduce(big, op=hvd.Sum))
    _exact(fails, "fp8_allreduce", hvd.collective_ops.fp8_allreduce(big),
           _fp8_round_trip(big))
    _exact(fails, "allreduce(compression=fp8)",
           hvd.allreduce(big, op=hvd.Sum, compression=hvd.Compression.fp8),
           _fp8_round_trip(big))
    ops_checked += 3
    timed = {
        "allreduce": lambda: hvd.allreduce(big, op=hvd.Sum),
        "allreduce_one_member_set": lambda: hvd.allreduce(
            big, op=hvd.Sum, process_set=one),
        "reducescatter": lambda: hvd.reducescatter(big, op=hvd.Sum),
        "reducescatter_one_member_set": lambda: hvd.reducescatter(
            big, op=hvd.Sum, process_set=one),
        "alltoall": lambda: hvd.alltoall(rows),
        "alltoall_splits": lambda: hvd.alltoall(rows,
                                                splits=[rows.shape[0]]),
        "allgather": lambda: hvd.allgather(rows),
        "broadcast": lambda: hvd.broadcast(big, 0),
        "grouped_allgather": lambda: hvd.grouped_allgather([rows]),
        "chunked_allreduce": lambda: hvd.collective_ops.chunked_allreduce(
            big, hvd.Sum, chunk_bytes=chunk),
        "fp8_allreduce": lambda: hvd.collective_ops.fp8_allreduce(big),
        # Yardsticks, not the port: one torch.distributed call, and the
        # copy an out-of-place op makes.
        "torch_distributed_all_reduce": lambda: torch.distributed.all_reduce(
            big),
        "clone": lambda: big.clone(),
    }
    ms = {k: time_ms(fn, reps=10, warmup=2) for k, fn in timed.items()}
    totals = {f"{op}/{ps}": v for (op, ps), v in collective_totals().items()}
    log({"phase": "torch_api", "card": card, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "sets": hvd.process_set_names(), "checks": ops_checked,
         "buffer_bytes": TORCH_API_BYTES, "ms": ms,
         "collective_counters": totals, "ok": not fails})
    if fails:
        raise AssertionError("torch_api: " + "; ".join(fails))
    hvd.remove_process_set(one)
    hvd.shutdown()
    del x, xi, big, rows


def train_torch_mnist(card: str) -> None:
    """``python -m horovod_tpu_torch.examples.pytorch_mnist``'s ``main()``
    on the card for 30 steps: the last loss below 0.7 of the first."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import pytorch_mnist

    run = pytorch_mnist.main(["--steps", str(TORCH_MNIST_STEPS)])
    step_ms = [1e3 * t for t in run.step_s]
    log({"phase": "torch_mnist", "card": card, "world": hvd.size(),
         "steps": TORCH_MNIST_STEPS, "losses": run.losses,
         "step_ms_after_first": sum(step_ms[1:]) / (len(step_ms) - 1),
         "step_ms_first": step_ms[0]})
    if not all(np.isfinite(run.losses)) or \
            not run.losses[-1] < 0.7 * run.losses[0]:
        raise AssertionError(f"torch_mnist: losses {run.losses}")
    hvd.shutdown()


def train_torch_resnet50(dev, card: str) -> dict:
    """``python -m horovod_tpu_torch.examples.torch_resnet50``'s setup at
    full width (224 x 224, batch 256, 53 ``SyncBatchNorm(process_set=ps)``
    sites, bf16 autocast, channels_last, ``DistributedOptimizer(SGD(0.1,
    momentum 0.9), compression=fp16, process_set=ps)``): one warm-up and
    five timed steps ending in a device sync.  Losses finite and falling,
    every parameter changed, 53 launches of each BN kernel and two sync-BN
    allreduces a site a step, the planned buckets with 2 bytes a value on
    the wire; the layout copies a step are printed (expected 0).  Returns
    the launch counts over the timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.examples import torch_resnet50 as ex
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import (exchange_totals,
                                                    sync_bn_totals)

    steps = 5
    args = ex.parse_args([])
    t0 = time.perf_counter()
    bench = ex.setup(args)
    model = bench.model
    named = list(model.named_parameters())
    values = sum(p.numel() for _, p in named)
    sites = sum(isinstance(m, hvd.SyncBatchNorm) for m in model.modules())
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    log({"phase": "torch_resnet50_init", "seconds": time.perf_counter() - t0,
         "world": hvd.size(), "backend": torch.distributed.get_backend(),
         "process_set": bench.process_set.name,
         "param_tensors": len(named), "param_values": values,
         "sync_bn_sites": sites, "batch": list(bench.batch[0].shape),
         "channels_last": bench.batch[0].is_contiguous(
             memory_format=torch.channels_last)})

    losses = [bench.step().item()]                 # warm-up
    before, before_bn = exchange_totals(), sync_bn_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(bench.step().item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    bn_per_step = {k: (v - before_bn[k]) / steps
                   for k, v in sync_bn_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    log({"phase": "torch_resnet50", "card": card, "steps": steps,
         "losses": losses, "step_ms": step_ms,
         "step_ms_each": [1e3 * t for t in times],
         "images_per_s": args.batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "bn_launches_per_step": {k: counts[k] / steps for k in
                                  ("bn_bwd_reduce", "bn_bwd_dx")},
         "sync_bn_per_step": bn_per_step,
         "params_changed": changed, "param_tensors": len(named)})
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named):
        fails.append(f"{len(named) - changed} parameters unchanged")
    if (values, len(named), sites) != (TORCH_RN50_VALUES,
                                       TORCH_RN50_TENSORS,
                                       RESNET50_BN_SITES):
        fails.append(f"model has {values} values in {len(named)} tensors "
                     f"and {sites} sync-BN sites")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != RESNET50_BN_SITES * steps:
            fails.append(f"{f} launches {counts[f]} != "
                         f"{RESNET50_BN_SITES * steps}")
    if bn_per_step["allreduces"] != 2 * RESNET50_BN_SITES:
        fails.append(f"sync-BN allreduces a step {bn_per_step}")
    if per_step != {"buckets": planned, "wire_bytes": TORCH_RN50_WIRE_BYTES,
                    "handles": planned}:
        fails.append(f"exchange per step {per_step}, planned {planned} "
                     f"buckets and {TORCH_RN50_WIRE_BYTES} wire bytes")
    if fails:
        raise AssertionError("torch_resnet50: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, bench, before_p
    return counts


EXCHANGE_TOPK = 0.25          # bench.py:272's fraction for topk:<f>
EXCHANGE_ZERO_TOL = 1e-6      # ZeRO-1 vs plain SGD: of max |param|


def _fp8_round_trip(buf: torch.Tensor) -> torch.Tensor:
    """``fp8_allreduce`` of one rank, by hand: quantize, dequantize, the
    f32 reduce of one row, quantize, dequantize."""
    from horovod_tpu_torch.collectives.compression import fp8_quantize
    q, s = fp8_quantize(buf.float().reshape(1, -1), axis=0)
    acc = (q.float() * s[:, None]).sum(0) / 1
    q2, s2 = fp8_quantize(acc)
    return (q2.float() * s2).view(buf.shape).to(buf.dtype)


def _timed_steps(step, batch, steps: int, after=None) -> tuple:
    """One warm-up and ``steps`` timed steps, ``after()`` (a check)
    outside the timing after each: (losses, ms each, launch counts,
    exchange and ZeRO counters moved a step, peak bytes)."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import (exchange_totals,
                                                    zero_totals)
    after = after or (lambda: None)
    losses = [step(batch).item()]
    after()
    before, zbefore = exchange_totals(legs=True), zero_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
        after()
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals(legs=True).items()}
    zero_step = {k: (v - zbefore[k]) / steps
                 for k, v in zero_totals().items() if k != "opt_state_bytes"}
    return losses, [1e3 * t for t in times], counts, per_step, zero_step, peak


def train_resnet_exchange(dev, card: str) -> dict:
    """``resnet_train``'s ResNet-50 (s2d, bf16, 256 x 224 x 224, weights
    from seed 0) through three exchanges, the model reset to its initial
    weights and only the optimizer rebuilt between them, each one warm-up
    and five timed steps:

    (a) ``zero_stage=1`` with the bare ``SGD(0.1, momentum 0.9)``
        (``bench.py``'s ``batch256_s2d_bf16_zero1``): the ZeRO-1 bytes a
        step equal ``zero_report``'s, and -- in two further runs of six
        steps from the initial weights with deterministic cuDNN
        algorithms, so that only the optimizer differs -- the parameters
        within 1e-6 of max |param| of plain SGD's (bitwise equality
        recorded);
    (b) ``DistributedOptimizer(SGD, compression=Compression.fp8)`` (the
        codec of ``bench_scaling.py``'s ``rn50-fp8``): on the first step
        each bucket's result is bitwise the fp8 round trip of its packed
        gradient, and the wire bytes a step are ``wire_payload_bytes``;
    (c) ``compression="topk:0.25"`` with error feedback: on every step
        ``own + new_residual == acc`` bitwise for every bucket, the
        residual zero exactly at the k sent indices and ``acc`` at the
        ``size - k`` others, and ``8k / 2`` wire bytes a bucket.

    Each prints its step ms, images/s, peak memory, buckets, handles and
    wire bytes a step, 53 + 53 BN launches a step and five finite losses.
    Returns the BN kernels' launches over the fifteen timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops as cops
    from horovod_tpu_torch.collectives.compression import (
        parse_compression, topk_count, wire_payload_bytes)
    from horovod_tpu_torch.optim import distributed
    from horovod_tpu_torch.optim import zero
    from horovod_tpu_torch.training import make_flax_train_step

    batch_size, steps = 256, 5
    hvd.init()
    model, _ = resnet50(dev, seed=0)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = images(torch.Generator(device=dev).manual_seed(0), dev,
                   batch_size, 1000)
    bn_total = {"bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    fails = []

    def reset():
        model.load_state_dict(init_state)
        gc.collect()

    def sgd():
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)

    def record(config, losses, ms, counts, per_step, zero_step, peak,
               **extra):
        step_ms = sum(ms) / len(ms)
        bn = {k: counts[k] / steps for k in bn_total}
        for k in bn_total:
            bn_total[k] += counts[k]
        log({"phase": "resnet_exchange", "config": config, "card": card,
             "batch": list(batch[0].shape), "steps": steps,
             "step_ms": step_ms, "step_ms_each": ms,
             "images_per_s": batch_size / (step_ms / 1e3),
             "peak_mem_bytes": peak, "exchange_per_step": per_step,
             "zero_per_step": zero_step, "bn_launches_per_step": bn,
             "losses": losses, **extra})
        if not all(np.isfinite(losses)):
            fails.append(f"{config}: a loss is not finite: {losses}")
        if bn != {k: RESNET50_BN_SITES for k in bn_total}:
            fails.append(f"{config}: BN launches a step {bn}")

    # (a) ZeRO-1, timed as the other phases (cuDNN's own algorithms).
    reset()
    step = make_flax_train_step(model, sgd(), zero_stage=1)
    report = zero.zero_report(sgd(), params, hvd.size())
    out = _timed_steps(step, batch, steps)
    state_bytes = step.zero_state.state_bytes()
    zero_step = out[4]
    bytes_ok = (zero_step["steps"] == 1 and
                zero_step["reducescatter_bytes"]
                + zero_step["allgather_bytes"]
                == report["zero1_exchanged_bytes_per_chip"]
                and state_bytes == report["opt_state_bytes_per_chip_zero1"])
    del step
    # ZeRO-1 against plain SGD: six steps each from the initial weights,
    # deterministic cuDNN algorithms in both runs.
    finals = {}
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for name, stage in (("plain", 0), ("zero1", 1)):
            reset()
            s = make_flax_train_step(model, sgd(), zero_stage=stage)
            for _ in range(steps + 1):
                s(batch)
            torch.cuda.synchronize()
            finals[name] = [p.detach().clone() for p in params]
            del s
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    scale = max(p.abs().max().item() for p in finals["plain"])
    zero_err = max((a - b).abs().max().item()
                   for a, b in zip(finals["zero1"], finals["plain"]))
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(finals["zero1"], finals["plain"]))
    del finals
    record("zero1", *out, report=report, opt_state_bytes=state_bytes,
           zero_report_bytes_equal=bytes_ok,
           vs_plain_sgd_max_abs_err=zero_err, vs_plain_sgd_tol=
           EXCHANGE_ZERO_TOL * scale, vs_plain_sgd_bitwise=bitwise)
    if not bytes_ok:
        fails.append(f"zero1: bytes {zero_step}, state {state_bytes} "
                     f"against zero_report {report}")
    if not zero_err <= EXCHANGE_ZERO_TOL * scale:
        fails.append(f"zero1: parameters {zero_err} from plain SGD's")
    free_device()

    # (b) fp8: the first step's buckets against the round trip.
    reset()
    opt = hvd.DistributedOptimizer(sgd(), named_parameters=named,
                                   compression=hvd.Compression.fp8)
    step = make_flax_train_step(model, opt)
    sizes = [sum(s.size for s in lspecs)
             for _, lspecs in opt.bucket_plan.buffers]
    wire = sum(wire_payload_bytes(hvd.Compression.fp8, n) for n in sizes)
    packed, reduced = [], []
    real_pack, real_unpack = distributed.pack_bucket, \
        distributed.unpack_bucket

    def pack_bucket(leaves, lspecs):
        buf = real_pack(leaves, lspecs)
        packed.append(buf.clone())
        return buf

    def unpack_bucket(buf, lspecs):
        reduced.append(buf)
        return real_unpack(buf, lspecs)

    distributed.pack_bucket, distributed.unpack_bucket = (pack_bucket,
                                                          unpack_bucket)
    try:
        step(batch)
    finally:
        distributed.pack_bucket, distributed.unpack_bucket = (real_pack,
                                                              real_unpack)
    round_trip = len(packed) == len(reduced) == len(sizes) and all(
        torch.equal(r, _fp8_round_trip(p)) for p, r in zip(packed, reduced))
    fp8_err = [(r - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
               for p, r in zip(packed, reduced)]
    del packed, reduced
    out = _timed_steps(step, batch, steps)
    per_step = out[3]
    record("fp8", *out, bucket_values=sizes, wire_payload_bytes=wire,
           first_step_round_trip_bitwise=round_trip,
           first_step_rel_err_vs_f32=fp8_err)
    nb = len(sizes)
    if not round_trip:
        fails.append("fp8: a bucket is not its round trip")
    if (per_step["buckets"], per_step["handles"], per_step["wire_bytes"]) \
            != (nb, 2 * nb, wire):
        fails.append(f"fp8: exchange a step {per_step}, {nb} buckets, "
                     f"{wire} wire bytes")
    del opt, step
    free_device()

    # (c) top-k with error feedback: own + residual == acc, every step.
    reset()
    comp = parse_compression(f"topk:{EXCHANGE_TOPK}")
    opt = hvd.DistributedOptimizer(sgd(), named_parameters=named,
                                   compression=comp)
    step = make_flax_train_step(model, opt)
    sizes = [sum(s.size for s in lspecs)
             for _, lspecs in opt.bucket_plan.buffers]
    wire = sum(wire_payload_bytes(comp, n) for n in sizes)
    seen, checks = [], []
    real_select = cops._topk_select

    def select(acc, k):
        idx = real_select(acc, k)
        seen.append((acc, idx))
        return idx

    def check_step():
        for acc, idx in seen:
            res = next(r for r in opt.residuals if r.numel() == acc.numel())
            own = torch.zeros_like(acc).index_put_((idx,), acc[idx])
            unsent = torch.ones_like(acc, dtype=torch.bool)
            unsent[idx] = False
            checks.append(
                bool(torch.equal(own + res, acc))
                and not res[idx].any().item()
                and bool(torch.equal(res[unsent], acc[unsent]))
                and int(unsent.sum()) == acc.numel() - topk_count(
                    acc.numel(), EXCHANGE_TOPK))
        seen.clear()

    cops._topk_select = select
    try:
        out = _timed_steps(step, batch, steps, after=check_step)
    finally:
        cops._topk_select = real_select
    per_step = out[3]
    residuals = [{"values": r.numel(), "nonzero": int((r != 0).sum()),
                  "finite": bool(torch.isfinite(r).all())}
                 for r in opt.residuals]
    record(f"topk:{EXCHANGE_TOPK}", *out, bucket_values=sizes,
           wire_payload_bytes=wire, ef_checks=len(checks),
           own_plus_residual_is_acc=all(checks), residuals=residuals)
    nb = len(sizes)
    if len(checks) != nb * (steps + 1) or not all(checks):
        fails.append(f"topk: own + residual == acc failed: {checks}")
    if (per_step["buckets"], per_step["handles"], per_step["wire_bytes"]) \
            != (nb, 2 * nb, wire):
        fails.append(f"topk: exchange a step {per_step}, {nb} buckets, "
                     f"{wire} wire bytes")
    if fails:
        raise AssertionError("resnet_exchange: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, params, opt, step, batch, init_state
    return bn_total


LOOP_K = 4                    # steps_per_execution of phase 21
LOOP_MICRO = 4                # microbatches of phase 21 (b) and (c)
LOOP_WINDOWS = 3              # eager, captured + replayed, replayed
LOOP_TIMED_WINDOWS = 3        # replayed windows timed after the checks


class _WithDropout(torch.nn.Module):
    """A model whose forward draws its dropout mask from ``gen``."""

    def __init__(self, inner, gen):
        super().__init__()
        self.inner, self.gen = inner, gen

    def forward(self, x):
        return self.inner(x, self.gen)


def _snapshot(model, opt) -> dict:
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out.update({f"momentum/{i}": st["momentum_buffer"].clone()
                for i, st in enumerate(opt.state.values())})
    return out


def _counters() -> tuple:
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline import metrics, spans
    return (registry.launch_counts(), metrics.exchange_totals(),
            spans.recorder().leg_registry())


def _reset_counters() -> None:
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline import metrics, spans
    registry.reset_launch_counts()
    metrics.reset_metrics()
    spans.recorder().reset()


def _per_step(counts: tuple, steps: int) -> dict:
    launches, exchange, legs = counts
    return {"bn_launches": {f: launches[f] / steps
                            for f in ("bn_bwd_reduce", "bn_bwd_dx")},
            "exchange": {k: v / steps for k, v in exchange.items()},
            "legs": {t: {k: n / steps for k, n in v.items()}
                     for t, v in legs.items()}}


def _eager_run(step, batches) -> tuple:
    """``step`` on each batch: (losses, wall ms each, host dispatch ms
    each -- the time until the call returns, before any sync)."""
    losses, wall, dispatch = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(b)
        dispatch.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
        losses.append(loss.clone())
    return torch.stack(losses), wall, dispatch


def _loop_run(loop, windows) -> tuple:
    """``loop`` on each stacked window: (losses, wall ms a step, host
    dispatch ms a window)."""
    losses, wall, dispatch = [], [], []
    for w in windows:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = loop(w)
        dispatch.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t) / LOOP_K)
        losses.append(out.clone())
    return torch.cat(losses), wall, dispatch


def _bitwise(a: dict, b: dict) -> list:
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def train_resnet_loop(dev, card: str) -> dict:
    """Phase 21: phase 8's ResNet-50 (s2d, bf16, 256 x 224 x 224, seed 0,
    ``DistributedOptimizer(SGD(0.1, momentum 0.9))``) with deterministic
    cuDNN, through

    (a) ``make_flax_train_loop(steps_per_execution=4)`` fed by
        ``DevicePrefetcher(depth=2, stack_steps=4)`` over a pool of two
        host batches from seed 0: three windows (eager, captured and
        replayed, replayed) bitwise equal -- parameters, BN statistics,
        momentum buffers, the twelve losses -- to twelve
        ``make_flax_train_step`` calls from the same start on the same
        batches; 53 + 53 BN launches and phase 8's exchange a step,
        counted over replays;
    (b) ``make_flax_train_step(microbatches=4)``: 4 x 53 launches of
        each BN kernel a step, four ``mb_rs`` rows and one ``mb_ag`` row
        a bucket in the leg registry as ``plan_exchange("microbatch")``
        gives them, the exchange counters priced from them, losses
        finite and falling;
    (c) the loop with ``steps_per_execution=4, microbatches=4``, bitwise
        equal to twelve calls of (b)'s step;
    (d) Inception-v3 (phase 14's cell: 32 x 299 x 299, SGD(0.01, momentum
        0.9), 94 BN sites) with dropout 0.5 drawn from an explicit
        generator registered with the graph, through the loop, bitwise
        equal to its eager steps.

    Each prints step ms (each), images/s, peak GB and the host ms to
    dispatch a window, against the eager steps in the same call, and
    the ResNet-50 buckets' ``render_plan``.  Returns the BN launches of
    the slice's entry points: every window of the loops, the checked and
    the timed ones, and (b)'s microbatched steps (not the single-shot
    eager references)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller import fusion
    from horovod_tpu_torch.data import DevicePrefetcher
    from horovod_tpu_torch.models import InceptionV3, init_params
    from horovod_tpu_torch.models.convert import flax_leaf_order
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)

    batch_size = 256
    steps = LOOP_K * LOOP_WINDOWS
    hvd.init()
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    bn_total = {"bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    fails = []
    try:
        model, _ = resnet50(dev, seed=0)
        named = list(model.named_parameters())
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator().manual_seed(0)
        pool = [(torch.randn(batch_size, 224, 224, 3, generator=gen)
                 .to(torch.bfloat16),
                 torch.randint(0, 1000, (batch_size,), generator=gen))
                for _ in range(2)]
        host = [pool[i % 2] for i in range(steps)]
        on_dev = [tuple(t.to(dev) for t in b) for b in host]

        def fresh():
            model.load_state_dict(init_state)
            gc.collect()
            return hvd.DistributedOptimizer(
                torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
                named_parameters=named)

        def record(config, losses, wall, dispatch, skip, peak, counts, ref,
                   **extra):
            step_ms = sum(wall[skip:]) / len(wall[skip:])
            log({"phase": "resnet_loop", "config": config, "card": card,
                 "batch": [batch_size, 224, 224, 3], "steps": len(losses),
                 "step_ms": step_ms, "step_ms_each": wall,
                 "images_per_s": batch_size / (step_ms / 1e3),
                 "dispatch_ms_each": dispatch, "peak_mem_bytes": peak,
                 "per_step": counts, "losses": losses.tolist(),
                 "eager": ref, **extra})
            if not bool(torch.isfinite(losses).all()):
                fails.append(f"{config}: a loss is not finite")

        # The eager reference: twelve make_flax_train_step calls.
        opt = fresh()
        step = make_flax_train_step(model, opt)
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        e_losses, e_wall, e_disp = _eager_run(step, on_dev)
        e_peak = torch.cuda.max_memory_allocated()
        e_counts = _per_step(_counters(), steps)
        e_state = _snapshot(model, opt)
        plan = fusion.explain_plan(opt._trainable, reverse=True)
        log({"phase": "resnet_loop_plan", "render_plan":
             fusion.render_plan(plan)})
        eager_a = {"step_ms": sum(e_wall[1:]) / (steps - 1),
                   "step_ms_each": e_wall, "dispatch_ms_each": e_disp,
                   "dispatch_ms_a_window": sum(e_disp[1:]) / (steps - 1)
                   * LOOP_K,
                   "images_per_s": batch_size * (steps - 1) / sum(e_wall[1:])
                   * 1e3, "peak_mem_bytes": e_peak}
        del step, opt

        # (a) The loop, fed by the prefetcher.
        opt = fresh()
        loop = make_flax_train_loop(model, opt, steps_per_execution=LOOP_K)
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        with DevicePrefetcher(host, depth=2, device=dev,
                              stack_steps=LOOP_K) as pf:
            l_losses, l_wall, l_disp = _loop_run(loop, pf)
        counts = _counters()
        l_counts = _per_step(counts, steps)
        diff = _bitwise(e_state, _snapshot(model, opt))
        bitwise = not diff and torch.equal(l_losses, e_losses)
        timed = [stack_steps(on_dev[:LOOP_K])] * LOOP_TIMED_WINDOWS
        _, t_wall, t_disp = _loop_run(loop, timed)
        peak = torch.cuda.max_memory_allocated()
        launched = _counters()[0]       # the checked and the timed windows
        for f in bn_total:
            bn_total[f] += launched[f]
        record("loop_k4", l_losses, l_wall + t_wall, l_disp + t_disp, 2,
               peak, l_counts, eager_a, bitwise_vs_eager=bitwise,
               differing=diff[:8], prefetched_windows=len(l_wall))
        if not bitwise:
            fails.append(f"loop_k4: not bitwise the eager steps: {diff[:8]}")
        if l_counts["bn_launches"] != {f: RESNET50_BN_SITES
                                       for f in bn_total}:
            fails.append(f"loop_k4: BN launches a step "
                         f"{l_counts['bn_launches']}")
        if l_counts["exchange"] != e_counts["exchange"] or \
                l_counts["legs"] != e_counts["legs"]:
            fails.append(f"loop_k4: exchange a step {l_counts} != eager "
                         f"{e_counts}")
        del loop, opt
        free_device()

        # (b) Microbatches, eager: also (c)'s reference.
        opt = fresh()
        step = make_flax_train_step(model, opt, microbatches=LOOP_MICRO)
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        b_losses, b_wall, b_disp = _eager_run(step, on_dev)
        b_peak = torch.cuda.max_memory_allocated()
        counts = _counters()
        b_counts = _per_step(counts, steps)
        b_state = _snapshot(model, opt)
        for f in bn_total:
            bn_total[f] += counts[0][f]
        leaves = [opt._trainable[i] for i in flax_leaf_order(
            [opt._name_of[id(p)] for p in opt._trainable])]
        spec = fusion.plan_buckets(leaves, reverse=True)
        legs = fusion.plan_exchange(
            "microbatch", buffers=tuple((dt, sum(x.size for x in ls))
                                        for dt, ls in spec.buffers),
            k=LOOP_MICRO, world=hvd.size()).legs
        nb = len(spec.buffers)
        want_legs = {
            "microbatch_rs": {"nbytes": LOOP_MICRO * sum(
                leg.nbytes for leg in legs[:nb]), "buckets": LOOP_MICRO * nb},
            "microbatch_ag": {"nbytes": sum(leg.nbytes for leg in legs[nb:]),
                              "buckets": nb}}
        want_exchange = {"buckets": nb, "handles": nb * (LOOP_MICRO + 1),
                         "wire_bytes": want_legs["microbatch_rs"]["nbytes"]
                         + want_legs["microbatch_ag"]["nbytes"]}
        eager_b = {"step_ms": sum(b_wall[1:]) / (steps - 1),
                   "dispatch_ms_a_window": sum(b_disp[1:]) / (steps - 1)
                   * LOOP_K, "peak_mem_bytes": b_peak}
        record("microbatches4", b_losses, b_wall, b_disp, 1, b_peak,
               b_counts, eager_a, planned_legs=want_legs)
        if b_counts["bn_launches"] != {f: LOOP_MICRO * RESNET50_BN_SITES
                                       for f in bn_total}:
            fails.append(f"microbatches4: BN launches a step "
                         f"{b_counts['bn_launches']}")
        if b_counts["legs"] != {t: {k: float(v) for k, v in w.items()}
                                for t, w in want_legs.items()} or \
                b_counts["exchange"] != want_exchange:
            fails.append(f"microbatches4: legs/exchange a step "
                         f"{b_counts} != planned {want_legs}, "
                         f"{want_exchange}")
        if not b_losses[-2] < b_losses[0]:      # both on the pool's batch 0
            fails.append(f"microbatches4: loss did not fall {b_losses}")
        del step, opt
        free_device()

        # (c) Both: the loop of (b)'s step.
        opt = fresh()
        loop = make_flax_train_loop(model, opt, steps_per_execution=LOOP_K,
                                    microbatches=LOOP_MICRO)
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        c_windows = [stack_steps(on_dev[i * LOOP_K:(i + 1) * LOOP_K])
                     for i in range(LOOP_WINDOWS)]
        c_losses, c_wall, c_disp = _loop_run(loop, c_windows)
        counts = _counters()
        c_counts = _per_step(counts, steps)
        diff = _bitwise(b_state, _snapshot(model, opt))
        bitwise = not diff and torch.equal(c_losses, b_losses)
        _, t_wall, t_disp = _loop_run(loop, c_windows[:1]
                                      * LOOP_TIMED_WINDOWS)
        peak = torch.cuda.max_memory_allocated()
        launched = _counters()[0]       # the checked and the timed windows
        for f in bn_total:
            bn_total[f] += launched[f]
        record("loop_k4_microbatches4", c_losses, c_wall + t_wall,
               c_disp + t_disp, 2, peak, c_counts, eager_b,
               bitwise_vs_eager=bitwise, differing=diff[:8])
        if not bitwise:
            fails.append(f"loop_k4_microbatches4: not bitwise: {diff[:8]}")
        if c_counts != b_counts:
            fails.append(f"loop_k4_microbatches4: a step {c_counts} != "
                         f"eager {b_counts}")
        del loop, opt, c_windows, on_dev, host, pool, model, named
        del init_state
        free_device()

        # (d) Inception-v3 with dropout from a registered generator.
        inc_batch = 32
        gen = torch.Generator(device=dev).manual_seed(0)
        inner = InceptionV3(num_classes=1000, dtype=torch.bfloat16,
                            image_size=299, device=dev)
        inner.load_state_dict(init_params(inner, generator=gen))
        drop = torch.Generator(device=dev)
        model = _WithDropout(inner, drop)
        inc_named = list(model.named_parameters())
        inc_init = {k: v.clone() for k, v in model.state_dict().items()}
        gen.manual_seed(1)
        data = [(torch.randn(inc_batch, 299, 299, 3, generator=gen,
                             device=dev).to(torch.bfloat16),
                 torch.randint(0, 1000, (inc_batch,), generator=gen,
                               device=dev)) for _ in range(2)]
        inc_data = [data[i % 2] for i in range(steps)]

        def inc_fresh():
            model.load_state_dict(inc_init)
            drop.manual_seed(7)
            gc.collect()
            return hvd.DistributedOptimizer(
                torch.optim.SGD([p for _, p in inc_named], lr=0.01,
                                momentum=0.9), named_parameters=inc_named)

        opt = inc_fresh()
        step = make_flax_train_step(model, opt)
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        d_losses, d_wall, d_disp = _eager_run(step, inc_data)
        d_peak = torch.cuda.max_memory_allocated()
        d_counts = _per_step(_counters(), steps)
        d_state = _snapshot(model, opt)
        eager_d = {"step_ms": sum(d_wall[1:]) / (steps - 1),
                   "step_ms_each": d_wall, "dispatch_ms_each": d_disp,
                   "dispatch_ms_a_window": sum(d_disp[1:]) / (steps - 1)
                   * LOOP_K,
                   "images_per_s": inc_batch * (steps - 1) / sum(d_wall[1:])
                   * 1e3, "peak_mem_bytes": d_peak}
        del step
        opt = inc_fresh()
        loop = make_flax_train_loop(model, opt, steps_per_execution=LOOP_K,
                                    generators=(drop,))
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        i_windows = [stack_steps(inc_data[i * LOOP_K:(i + 1) * LOOP_K])
                     for i in range(LOOP_WINDOWS)]
        i_losses, i_wall, i_disp = _loop_run(loop, i_windows)
        counts = _counters()
        i_counts = _per_step(counts, steps)
        diff = _bitwise(d_state, _snapshot(model, opt))
        bitwise = not diff and torch.equal(i_losses, d_losses)
        _, t_wall, t_disp = _loop_run(loop, i_windows[:1]
                                      * LOOP_TIMED_WINDOWS)
        peak = torch.cuda.max_memory_allocated()
        launched = _counters()[0]       # the checked and the timed windows
        for f in bn_total:
            bn_total[f] += launched[f]
        step_ms = sum(i_wall[LOOP_K:] + t_wall) / len(i_wall[LOOP_K:]
                                                      + t_wall)
        log({"phase": "resnet_loop", "config": "inception_v3_loop_k4",
             "card": card, "batch": [inc_batch, 299, 299, 3],
             "steps": steps, "step_ms": step_ms,
             "step_ms_each": i_wall + t_wall,
             "images_per_s": inc_batch / (step_ms / 1e3),
             "dispatch_ms_each": i_disp + t_disp, "peak_mem_bytes": peak,
             "per_step": i_counts, "losses": i_losses.tolist(),
             "eager": eager_d, "bitwise_vs_eager": bitwise,
             "differing": diff[:8], "dropout_rate": inner.Dropout_0.rate})
        if not bitwise:
            fails.append(f"inception_v3_loop_k4: not bitwise: {diff[:8]}")
        if i_counts != d_counts or i_counts["bn_launches"] != {
                f: INCEPTION_BN_SITES for f in bn_total}:
            fails.append(f"inception_v3_loop_k4: a step {i_counts} != "
                         f"eager {d_counts}")
        if not bool(torch.isfinite(i_losses).all()):
            fails.append("inception_v3_loop_k4: a loss is not finite")
        del loop, opt, model, inner, i_windows, inc_data, data, inc_init
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    if fails:
        raise AssertionError("resnet_loop: " + "; ".join(fails))
    hvd.shutdown()
    return bn_total


ELASTIC_STEPS = 12            # phase 22 (b): steps of each run
ELASTIC_COMMIT_EVERY = 2      # commits every 2 steps
ELASTIC_CHAOS = "seed=7;comm@step=5,rank=0"
ELASTIC_LOOP_CHAOS = "seed=7;comm@step=3,rank=0"   # a commit a window
ELASTIC_LAUNCH_BATCHES = 8    # phase 22 (a): ELASTIC_TARGET_BATCHES
ELASTIC_LAUNCH_BATCH = 64     # each rank's batch in (a)
ELASTIC_LAUNCH_TIMEOUT = 300


def _launch_elastic(tmp: str, network: bool) -> dict:
    """Phase 22 (a): one ``python -m horovod_tpu_torch.run`` elastic run of
    the example at full ResNet-50 width; its wall seconds, the worker's
    step ms and its elastic metrics line."""
    here = os.path.dirname(os.path.abspath(__file__))
    disc = os.path.join(tmp, "discover.sh")
    with open(disc, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(disc, 0o755)
    env = dict(os.environ, PYTHONPATH=here,
               ELASTIC_MODEL="resnet50", ELASTIC_IMAGE_SIZE="224",
               ELASTIC_TARGET_BATCHES=str(ELASTIC_LAUNCH_BATCHES),
               ELASTIC_BATCH_DELAY_S="0",
               ELASTIC_BATCH=str(ELASTIC_LAUNCH_BATCH))
    for k in ("HVD_TPU_FORCE_CPU", "HOROVOD_CHAOS", "HVD_TPU_CHAOS",
              "HOROVOD_RANK", "HOROVOD_SIZE", "HVD_TPU_RENDEZVOUS_FILE"):
        env.pop(k, None)
    args = [sys.executable, "-m", "horovod_tpu_torch.run",
            "--host-discovery-script", disc, "--min-np", "1",
            "--max-np", "1"]
    if network:
        env["HOROVOD_CHAOS"] = "seed=3;kv_blackout@step=3,secs=2;" \
                               "hb_drop@step=5,secs=1"
        args += ["--network-rendezvous", "--heartbeat-timeout", "30"]
    args += [sys.executable, "-m",
             "horovod_tpu_torch.examples.elastic_train"]
    t = time.perf_counter()
    try:
        out = subprocess.run(args, env=env, cwd=here, capture_output=True,
                             text=True, timeout=ELASTIC_LAUNCH_TIMEOUT)
        code, text = out.returncode, out.stdout + out.stderr
    except subprocess.TimeoutExpired as e:
        code, text = "timeout", f"{e.stdout or ''}{e.stderr or ''}"
    wall = time.perf_counter() - t
    steps = [float(m.group(1)) for m in
             re.finditer(r"rank 0/1 batch \d+ loss \S+ step_ms (\S+)", text)]
    metrics = re.search(r"elastic metrics (\{.*\})", text)
    return {"network_rendezvous": network, "exit": code,
            "wall_s": wall, "final_size_1": "final size 1" in text,
            "batches": len(steps), "step_ms_each": steps,
            "step_ms_after_first": (sum(steps[1:]) / len(steps[1:])
                                    if len(steps) > 1 else None),
            "worker_metrics": json.loads(metrics.group(1)) if metrics
            else None, "chaos": env.get("HOROVOD_CHAOS"),
            "tail": text[-1500:]}


class _TimedState:
    """Wraps a TorchState's ``commit``/``restore`` with wall timers (the
    device is synchronized first, so a commit's time is its own)."""

    def __init__(self, state):
        self.commit_ms, self.restore_ms, self.restore_end = [], [], []
        for name, out in (("commit", self.commit_ms),
                          ("restore", self.restore_ms)):
            inner = getattr(state, name)

            def timed(inner=inner, out=out, name=name):
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    return inner()
                finally:
                    torch.cuda.synchronize()
                    out.append(1e3 * (time.perf_counter() - t))
                    if name == "restore":
                        self.restore_end.append(time.perf_counter())

            setattr(state, name, timed)


def _elastic_train(hvd, model, opt, data, spec, loop=None):
    """Phase 22 (b): ``len(data)`` steps of ``make_flax_train_step`` (or
    the windows of ``loop``) under ``@hvd.elastic.run`` with a
    ``TorchState`` committing every 2 steps (every window), ``spec``
    chaos installed after its constructor.  The step is rebuilt at every
    entry; the loop object is kept, so a re-init makes it capture again.
    Returns the losses by step and the timings."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.elastic import chaos
    from horovod_tpu_torch.training import make_flax_train_step, stack_steps

    chaos.reset()
    state = elastic.TorchState(model=model, optimizer=opt, batch=0)
    timers = _TimedState(state)
    if spec:
        chaos.install(spec, rank=0, size=1)
    losses, entries, step_ms = {}, [], []

    @elastic.run
    def train(state):
        entries.append((state.batch, time.perf_counter(),
                        hvd.core.state.global_state().generation,
                        len(step_ms)))
        step = None if loop is not None else make_flax_train_step(model, opt)
        while state.batch < len(data):
            b = state.batch
            torch.cuda.synchronize()
            t = time.perf_counter()
            if loop is not None:
                out = loop(stack_steps(data[b:b + LOOP_K])).clone()
                n = LOOP_K
            else:
                out = step(data[b]).reshape(1).clone()
                n = 1
            torch.cuda.synchronize()
            step_ms.append((b, n, 1e3 * (time.perf_counter() - t)))
            for i in range(n):
                losses[b + 1 + i] = out[i]
            state.batch += n
            if loop is not None or state.batch % ELASTIC_COMMIT_EVERY == 0:
                state.commit()
        return state.batch

    done = train(state)
    chaos.reset()
    return {"done": done, "losses": losses, "entries": entries,
            "step_ms": step_ms, "commit_ms": timers.commit_ms,
            "restore_ms": timers.restore_ms,
            "restore_end": timers.restore_end}


def elastic_resnet(dev, card: str, phase8_step_ms: float) -> tuple:
    """Phase 22 (see the module docstring).  Returns the BN launches of
    (b)'s runs (the eager and loop runs with their replayed steps) and
    the eager run's median commit ms."""
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline import metrics
    from horovod_tpu_torch.training import make_flax_train_loop

    fails = []
    # (a) The launcher and the elastic driver on the card.
    with tempfile.TemporaryDirectory(prefix="hvd_elastic_smoke_") as tmp:
        for network in (False, True):
            run = _launch_elastic(tmp, network)
            log({"phase": "elastic_launch", "card": card, **run})
            if run["exit"] != 0 or not run["final_size_1"] or \
                    run["batches"] < ELASTIC_LAUNCH_BATCHES:
                fails.append(f"launcher run (network={network}) exit "
                             f"{run['exit']}: {run['tail'][-600:]}")
    if fails:
        raise AssertionError("elastic_resnet: " + "; ".join(fails))

    # (b) Checkpointless recovery at full width, in process.
    batch_size = 256
    hvd.init()
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    bn_total = {"bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    try:
        model, _ = resnet50(dev, seed=0)
        named = list(model.named_parameters())
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        pool = [images(gen, dev, batch_size, 1000) for _ in range(2)]
        data = [pool[i % 2] for i in range(ELASTIC_STEPS)]

        def fresh():
            model.load_state_dict(init_state)
            gc.collect()
            return hvd.DistributedOptimizer(
                torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
                named_parameters=named, compression=hvd.Compression.none)

        runs = {}
        for name, spec, use_loop in (
                ("eager", None, False), ("eager_chaos", ELASTIC_CHAOS, False),
                ("loop_chaos", ELASTIC_LOOP_CHAOS, True)):
            opt = fresh()
            loop = make_flax_train_loop(model, opt,
                                        steps_per_execution=LOOP_K) \
                if use_loop else None
            _reset_counters()
            torch.cuda.reset_peak_memory_stats()
            r = _elastic_train(hvd, model, opt, data, spec, loop)
            launches = registry.launch_counts()
            for f in bn_total:
                bn_total[f] += launches[f]
            r["state"] = _snapshot(model, opt)
            r["peak"] = torch.cuda.max_memory_allocated()
            r["launches"] = {f: launches[f] for f in bn_total}
            r["steps_to_recover"] = metrics.registry().gauge(
                "horovod_elastic_steps_to_recover").value
            if loop is not None:
                r["loop_generation"] = loop._generation
                r["loop_captured"] = loop._graph is not None
            runs[name] = r
            del opt, loop
        ref = runs["eager"]
        last = list(range(ELASTIC_STEPS - 7, ELASTIC_STEPS + 1))
        for name in ("eager_chaos", "loop_chaos"):
            r = runs[name]
            diff = _bitwise(ref["state"], r["state"])
            losses_equal = sorted(r["losses"]) == list(
                range(1, ELASTIC_STEPS + 1)) and all(
                torch.equal(ref["losses"][k], r["losses"][k]) for k in last)
            entries = r["entries"]
            recovered = len(entries) == 2
            first_after = r["step_ms"][entries[1][3]][2] if recovered \
                else None
            # The re-init: from the restore's end to the re-entry (the
            # shutdown, init, resize and sync in between).
            reinit_ms = 1e3 * (entries[1][1] - r["restore_end"][0]) \
                if recovered and r["restore_end"] else None
            steady = sorted(ms / n for b, n, ms in ref["step_ms"][1:])
            step_ms = steady[len(steady) // 2]
            commits = sorted(r["commit_ms"])
            # Every step run, the replayed ones included.
            expected = RESNET50_BN_SITES * sum(n for _, n, _ in r["step_ms"])
            entry = {
                "phase": "elastic_resnet", "config": name, "card": card,
                "batch": [batch_size, 224, 224, 3], "chaos": ELASTIC_CHAOS
                if name == "eager_chaos" else ELASTIC_LOOP_CHAOS,
                "steps": ELASTIC_STEPS, "recovered": recovered,
                "rolled_back_to_step": entries[1][0] if recovered else None,
                "generations": [e[2] for e in entries],
                "horovod_elastic_steps_to_recover": r["steps_to_recover"],
                "restore_ms": r["restore_ms"], "reinit_ms": reinit_ms,
                "first_step_after_ms": first_after,   # a window for the loop
                "recovery_ms": (r["restore_ms"][0] + reinit_ms + first_after
                                if recovered and first_after is not None
                                and reinit_ms is not None else None),
                "commit_ms_median": commits[len(commits) // 2],
                "commit_ms_each": r["commit_ms"],
                "step_ms_uninterrupted": step_ms,
                "phase8_step_ms": phase8_step_ms,
                "step_ms_each": [(b, n, ms) for b, n, ms in r["step_ms"]],
                "peak_mem_bytes": r["peak"],
                "peak_mem_bytes_uninterrupted": ref["peak"],
                "bn_launches": r["launches"],
                "bitwise_vs_uninterrupted": not diff and losses_equal,
                "differing": diff[:8],
                "losses": [ref["losses"][k].item() for k in last]}
            if name == "loop_chaos":
                entry["loop_captured_again"] = r["loop_captured"] and \
                    r["loop_generation"] == entries[-1][2]
            log(entry)
            if name == "eager_chaos":
                commit_median = entry["commit_ms_median"]
            if not recovered:
                fails.append(f"{name}: the fault never fired ({entries})")
            if diff or not losses_equal:
                fails.append(f"{name}: not bitwise the uninterrupted run: "
                             f"{diff[:8]}, losses equal {losses_equal}")
            if r["steps_to_recover"] < 1:
                fails.append(f"{name}: no step was rolled back")
            if r["launches"] != {f: expected for f in bn_total}:
                fails.append(f"{name}: BN launches {r['launches']} != "
                             f"{expected} each")
            if name == "loop_chaos" and not entry["loop_captured_again"]:
                fails.append("loop_chaos: the loop did not capture again "
                             "after the re-init")
        if ref["launches"] != {f: RESNET50_BN_SITES * ELASTIC_STEPS
                               for f in bn_total}:
            fails.append(f"eager: BN launches {ref['launches']}")
        if not all(bool(torch.isfinite(v).all())
                   for v in ref["losses"].values()):
            fails.append("eager: a loss is not finite")
        del model, named, init_state, pool, data, runs
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    if fails:
        raise AssertionError("elastic_resnet: " + "; ".join(fails))
    hvd.shutdown()
    return bn_total, commit_median


SDC_STEPS = 12                # phase 23: steps of each run
SDC_POISON_FROM = 7           # the nan wedge poisons steps >= 7
SDC_CHAOS = "seed=7;nan@step=4,rank=0"        # fires at the commit after 6
SDC_LOOP_CHAOS = "seed=7;nan@step=2,rank=0"   # fires after window 1
SDC_ENV = {"HOROVOD_GUARD": "1", "HOROVOD_GUARD_STREAK": "3",
           "HOROVOD_SNAPSHOT_STEPS": "2", "HOROVOD_CHECK_DESYNC": "1",
           "HOROVOD_DESYNC_CHECK_STEPS": "2", "HOROVOD_METRICS_PORT": "0"}
SDC_FAMILIES = ("horovod_guard_steps_total", "horovod_guard_skipped_total",
                "horovod_guard_rollbacks_total",
                "horovod_guard_tripwire_checks_total",
                "horovod_step_total", "horovod_step_time_seconds",
                "horovod_straggler_rank",
                "horovod_straggler_rank_wall_seconds")


def _sdc_train(hvd, model, opt, data, spec, loop=None, watch=None):
    """Phase 23 (b) and (c): ``len(data)`` guarded steps of
    ``make_flax_train_step`` (or the windows of ``loop``) under
    ``@hvd.elastic.run`` with a ``TorchState`` committing every 2 steps
    (every window).  Once the ``spec`` chaos fault's ``nan`` latch is
    consumed, every batch of step ``SDC_POISON_FROM`` on is NaN-poisoned
    until the run loop rolls back (the replay reads healed data).  With
    ``watch``, each poisoned eager step's state is compared with the
    state before it (``watch`` collects the differing names)."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.elastic import chaos
    from horovod_tpu_torch.training import make_flax_train_step, stack_steps

    chaos.reset()
    state = elastic.TorchState(model=model, optimizer=opt, batch=0)
    timers = _TimedState(state)
    chaos.install(spec, rank=0, size=1)
    losses, entries, step_ms, wedged = {}, [], [], [False]
    tried, graphs = [0], []

    def batch_of(b):
        if wedged[0] and b + 1 >= SDC_POISON_FROM:
            return chaos.poison_batch(data[b])
        return data[b]

    @elastic.run
    def train(state):
        entries.append((state.batch, time.perf_counter(), len(step_ms)))
        wedged[0] = False
        step = None if loop is not None else make_flax_train_step(model, opt)
        while state.batch < len(data):
            b = state.batch
            if chaos.consume_nan_poison() is not None:
                wedged[0] = True
            torch.cuda.synchronize()
            t = time.perf_counter()
            if loop is not None:
                tried[0] += LOOP_K
                try:
                    out = loop(stack_steps([batch_of(i) for i in
                                            range(b, b + LOOP_K)])).clone()
                finally:
                    graphs.append(id(loop._graph))
                n = LOOP_K
            else:
                use = batch_of(b)
                before = _snapshot(model, opt) if watch is not None and \
                    use is not data[b] else None
                tried[0] += 1
                try:
                    out = step(use).reshape(1).clone()
                finally:
                    if before is not None:
                        watch.append((b + 1, _bitwise(
                            before, _snapshot(model, opt))))
                n = 1
            torch.cuda.synchronize()
            step_ms.append((b, n, 1e3 * (time.perf_counter() - t)))
            for i in range(n):
                losses[b + 1 + i] = out[i]
            state.batch += n
            if loop is not None or state.batch % ELASTIC_COMMIT_EVERY == 0:
                state.commit()
        return state.batch

    done = train(state)
    chaos.reset()
    return {"done": done, "losses": losses, "entries": entries,
            "step_ms": step_ms, "commit_ms": timers.commit_ms,
            "restore_ms": timers.restore_ms,
            "restore_end": timers.restore_end, "tried": tried[0],
            "graphs": graphs}


def _commit_costs(hvd, model, opt, reps: int = 3) -> dict:
    """Phase 23 (d): the median ms of a commit with the desync check and
    the tripwire on and with both off, of one ``check_desync`` and of
    one tripwire check, on ResNet-50's state."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.core import desync
    from horovod_tpu_torch.core.state import global_state

    st = global_state()
    on = st.config
    state = elastic.TorchState(model=model, optimizer=opt, batch=0)
    timers = _TimedState(state)
    out = {}
    try:
        # Checked: the CRC desync check and the tripwire at every commit.
        for name, cfg in (
                ("commit_checked", dataclasses.replace(
                    on, check_desync=True, desync_check_steps=1)),
                ("commit_unchecked", dataclasses.replace(
                    on, check_desync=False, desync_check_steps=0))):
            st.config = cfg
            timers.commit_ms.clear()
            for _ in range(reps):
                state.commit()
            out[name] = sorted(timers.commit_ms)[reps // 2]
    finally:
        st.config = on
    tree = desync.module_tree(model)
    for name, fn in (("check_desync", lambda: desync.check_desync(tree)),
                     ("tripwire", lambda: desync.tripwire_check(tree))):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        out[name + "_ms"] = sorted(ms)[reps // 2]
        out[name + "_found"] = res
    out["tripwire_value"] = desync.local_checksum(tree)
    return out


def sdc_resnet(dev, card: str, phase8_step_ms: float,
               phase22_commit_ms: float) -> dict:
    """Phase 23 (see the module docstring).  Returns the BN launches of
    its runs, replayed and skipped steps included."""
    import tempfile
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import guard
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline import DispatchGapMonitor
    from horovod_tpu_torch.timeline import __main__ as merge_cli
    from horovod_tpu_torch.timeline import metrics
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step)

    fails = []
    bn_total = {"bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    tmp = tempfile.mkdtemp(prefix="hvd_sdc_smoke_")
    tl_path = os.path.join(tmp, "timeline.json")
    saved_env = {k: os.environ.get(k) for k in
                 list(SDC_ENV) + ["HOROVOD_TIMELINE"]}
    os.environ.update(SDC_ENV, HOROVOD_TIMELINE=tl_path)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    _reset_counters()
    hvd.init()
    st = global_state()
    try:
        model, _ = resnet50(dev, seed=0)
        named = list(model.named_parameters())
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        pool = [images(gen, dev, 256, 1000) for _ in range(2)]
        data = [pool[i % 2] for i in range(SDC_STEPS)]

        def fresh():
            model.load_state_dict(init_state)
            gc.collect()
            return hvd.DistributedOptimizer(
                torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
                named_parameters=named, compression=hvd.Compression.none)

        def launches_into(total):
            got = registry.launch_counts()
            for f in total:
                total[f] += got[f]
            registry.reset_launch_counts()
            return {f: got[f] for f in total}

        # (a) The clean guarded run against the unguarded one.
        runs = {}
        registry.reset_launch_counts()
        for name, mode in (("unguarded", "0"), ("guarded", "1")):
            opt = fresh()
            cfg = st.config
            st.config = dataclasses.replace(cfg, guard=mode)
            step = make_flax_train_step(model, opt)
            st.config = cfg
            guard.reset()
            gap = DispatchGapMonitor(timeline=st.timeline) \
                if mode == "1" else None
            losses, ms = [], []
            for b in data:
                torch.cuda.synchronize()
                t = time.perf_counter()
                if gap is not None:
                    gap.begin_window()
                    with gap.dispatch():
                        loss = step(b)
                    gap.end_window()
                else:
                    loss = step(b)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                losses.append(loss.clone())
            pol = guard.policy()
            runs[name] = {"state": _snapshot(model, opt),
                          "losses": torch.stack(losses), "ms": ms,
                          "guard": (pol.steps, pol.skipped),
                          "launches": launches_into(bn_total),
                          "guarded_step": type(step._fn).__name__,
                          "gap": gap.gap_fraction if gap else None}
            del opt, step
        ref, grd = runs["unguarded"], runs["guarded"]
        diff = _bitwise(ref["state"], grd["state"])
        med = {k: sorted(r["ms"][1:])[len(r["ms"][1:]) // 2]
               for k, r in runs.items()}
        entry_a = {
            "phase": "sdc_resnet", "part": "a_clean", "card": card,
            "batch": [256, 224, 224, 3], "steps": SDC_STEPS,
            "step_ms_guarded": med["guarded"],
            "step_ms_unguarded": med["unguarded"],
            "guard_overhead_pct": 100.0 * (med["guarded"] / med["unguarded"]
                                           - 1.0),
            "phase8_step_ms": phase8_step_ms,
            "guard_steps_skipped": grd["guard"],
            "guarded_step": grd["guarded_step"],
            "dispatch_gap_fraction": grd["gap"],
            "bitwise_vs_unguarded": not diff and torch.equal(
                ref["losses"], grd["losses"]),
            "differing": diff[:8],
            "bn_launches": grd["launches"]}
        log(entry_a)
        if not entry_a["bitwise_vs_unguarded"]:
            fails.append(f"(a) guarded run not bitwise the unguarded: "
                         f"{diff[:8]}")
        if grd["guard"] != (SDC_STEPS, 0) or \
                grd["guarded_step"] != "_GuardedStep":
            fails.append(f"(a) guard steps/skips {grd['guard']}, step "
                         f"{grd['guarded_step']}")
        clean = grd["state"]
        clean_losses = grd["losses"]
        del runs, ref, grd

        # (b) Poisoned input, eager, and (c) through the loop.
        out = {}
        for name, spec, use_loop in (("b_eager", SDC_CHAOS, False),
                                     ("c_loop", SDC_LOOP_CHAOS, True)):
            opt = fresh()
            guard.reset()
            loop = make_flax_train_loop(model, opt,
                                        steps_per_execution=LOOP_K) \
                if use_loop else None
            before = metrics.registry().snapshot()
            watch = [] if not use_loop else None
            torch.cuda.reset_peak_memory_stats()
            r = _sdc_train(hvd, model, opt, data, spec, loop, watch)
            r["launches"] = launches_into(bn_total)
            r["state"] = _snapshot(model, opt)
            r["peak"] = torch.cuda.max_memory_allocated()
            snap = metrics.registry().snapshot()

            def delta(fam):
                return snap.get(fam, {}).get("value", 0.0) - \
                    before.get(fam, {}).get("value", 0.0)

            entries = r["entries"]
            recovered = len(entries) == 2
            first_after = r["step_ms"][entries[1][2]][2] if recovered \
                else None
            rb_ms = r["restore_ms"][0] if r["restore_ms"] else None
            diff = _bitwise(clean, r["state"])
            losses_equal = sorted(r["losses"]) == list(
                range(1, SDC_STEPS + 1)) and all(
                torch.equal(clean_losses[k - 1], r["losses"][k])
                for k in range(1, SDC_STEPS + 1))
            expected = RESNET50_BN_SITES * r["tried"]
            entry = {
                "phase": "sdc_resnet", "part": name, "card": card,
                "chaos": spec, "poison_from_step": SDC_POISON_FROM,
                "recovered": recovered,
                "rolled_back_to_step": entries[1][0] if recovered else None,
                "horovod_guard_skipped_total": delta(
                    "horovod_guard_skipped_total"),
                "horovod_guard_rollbacks_total": delta(
                    "horovod_guard_rollbacks_total"),
                "horovod_guard_tripwire_checks_total": delta(
                    "horovod_guard_tripwire_checks_total"),
                "steps_to_recover": metrics.registry().gauge(
                    "horovod_elastic_steps_to_recover").value,
                "rollback_restore_ms": rb_ms,
                "first_step_after_ms": first_after,
                "recovery_ms": rb_ms + first_after
                if rb_ms is not None and first_after is not None else None,
                "commit_ms_median": sorted(r["commit_ms"])[
                    len(r["commit_ms"]) // 2],
                "phase22_commit_ms": phase22_commit_ms,
                "step_ms_each": r["step_ms"], "peak_mem_bytes": r["peak"],
                "bn_launches": r["launches"],
                "bitwise_vs_uninterrupted": not diff and losses_equal,
                "differing": diff[:8]}
            if watch is not None:
                entry["poisoned_steps_kept_state"] = [
                    (s, not d) for s, d in watch]
            else:
                # One capture: the rollback restores in place, so the
                # graph the loop holds stays valid and is replayed.
                entry["graph_ids_by_window"] = r["graphs"]
                entry["captures"] = len(set(r["graphs"][1:]))
            log(entry)
            if watch is not None and ([s for s, _ in watch] != [7, 8, 9]
                                      or any(d for _, d in watch)):
                fails.append(f"{name}: poisoned steps {watch}")
            want_back = 4 if use_loop else 6
            if not recovered or entry["rolled_back_to_step"] != want_back:
                fails.append(f"{name}: rollback {entries}, expected the "
                             f"ledger entry of step {want_back}")
            if diff or not losses_equal:
                fails.append(f"{name}: not bitwise the uninterrupted run: "
                             f"{diff[:8]}, losses equal {losses_equal}")
            if entry["horovod_guard_skipped_total"] != \
                    (3 if watch is not None else 6) or \
                    entry["horovod_guard_rollbacks_total"] != 1:
                fails.append(f"{name}: skipped "
                             f"{entry['horovod_guard_skipped_total']}, "
                             f"rollbacks "
                             f"{entry['horovod_guard_rollbacks_total']}")
            if r["launches"] != {f: expected for f in bn_total}:
                fails.append(f"{name}: BN launches {r['launches']} != "
                             f"{expected} each")
            out[name] = r
            del opt, loop
        if not torch.equal(torch.stack([out["b_eager"]["losses"][k]
                                        for k in range(1, 13)]),
                           torch.stack([out["c_loop"]["losses"][k]
                                        for k in range(1, 13)])):
            fails.append("(c) losses not bitwise (b)'s")

        # (d) The observability plane.
        costs = _commit_costs(hvd, model, fresh())
        url = f"http://127.0.0.1:{st.metrics_server.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
        missing = [f for f in SDC_FAMILIES if f"# TYPE {f} " not in text]
        launches_into(bn_total)
        del model, named, init_state, pool, data, out, clean
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
        hvd.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(tl_path) as f:
        events = json.load(f)
    dispatch = [e for e in events if e.get("name") == "dispatch"
                and e.get("ph") == "B"]
    gap_track = [e for e in events if e.get("ph") == "C"
                 and e.get("name") == "host_dispatch_gap"]
    cli = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.timeline",
                          "--merge", tmp], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(
                             os.path.abspath(__file__)))
    rep = merge_cli.merge(tmp, os.path.join(tmp, "merged_check.json"))
    entry_d = {
        "phase": "sdc_resnet", "part": "d_observability", "card": card,
        "timeline_events": len(events), "dispatch_events": len(dispatch),
        "host_dispatch_gap_samples": len(gap_track),
        "merge_cli_exit": cli.returncode,
        "merge_cli_head": cli.stdout[:400],
        "merged_steps": rep["per_rank"].get(0, {}).get("steps"),
        "metrics_families_missing": missing,
        "metrics_bytes": len(text), **costs,
        "commit_extra_ms": costs["commit_checked"]
        - costs["commit_unchecked"],
        "phase22_commit_ms": phase22_commit_ms,
        "note": "world 1: the tripwire sees one value and can name no rank"}
    log(entry_d)
    shutil.rmtree(tmp, ignore_errors=True)
    # Every step call of the eager runs is one dispatch event: 24 in (a),
    # each of (b)'s calls, and one a window of (c).
    if len(dispatch) < 2 * SDC_STEPS or len(gap_track) != SDC_STEPS:
        fails.append(f"(d) timeline: {len(dispatch)} dispatch events, "
                     f"{len(gap_track)} gap samples")
    if cli.returncode != 0 or "merged 1 rank trace(s)" not in cli.stdout \
            or not entry_d["merged_steps"]:
        fails.append(f"(d) merge CLI: {cli.returncode} {cli.stdout[-400:]}"
                     f"{cli.stderr[-400:]}")
    if missing:
        fails.append(f"(d) /metrics lacks {missing}")
    if costs["tripwire_found"] != [] or costs["check_desync_found"] != []:
        fails.append(f"(d) world-1 checks found {costs}")
    if fails:
        raise AssertionError("sdc_resnet: " + "; ".join(fails))
    return bn_total


AUTOTUNE_STEPS_PER_SAMPLE = 3  # phase 24: scored steps a sample
AUTOTUNE_SAMPLES = 6           # phase 24 (a): samples before the tuner locks
AUTOTUNE_LOOP_SAMPLES = 4      # phase 24 (b): five windows a sample
AUTOTUNE_AFTER = 3             # (a): timed steps once the tuner is locked
AUTOTUNE_AFTER_WINDOWS = 3     # (b): eager, capture and a replay at the best
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_CHUNK": "1"}
AUTOTUNE_LAUNCH_TIMEOUT = 300
AUTOTUNE_WORKER = (
    "import horovod_tpu_torch as hvd\n"
    "from horovod_tpu_torch.core.state import global_state\n"
    "hvd.init()\n"
    "st = global_state()\n"
    "print(f'autotune worker rank {hvd.rank()} size {hvd.size()} device "
    "{st.device.type} tuner {type(st.autotuner).__name__}', flush=True)\n"
    "hvd.shutdown()\n")


def _median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def _autotune_run(model, opt, pool, tuner, n: int = 0,
                  loop_k: int = 0) -> dict:
    """Phase 24: phase 8's step (or the loop of ``loop_k`` over windows
    of the pool) under ``tuner`` until it locks and then ``AUTOTUNE_AFTER``
    steps (``AUTOTUNE_AFTER_WINDOWS`` windows) more; or, with ``tuner``
    None, ``n`` untuned calls.  A call's ms (host clock, synchronized),
    its trace key, the buckets the exchange counted and the optimizer
    planned, and the BN launches."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline import metrics
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    st = global_state()
    st.autotuner = tuner
    registry.reset_launch_counts()
    out = {"losses": [], "ms": [], "keys": [], "buckets": [], "planned": []}
    try:
        if loop_k:
            fn = make_flax_train_loop(model, opt, steps_per_execution=loop_k)
            batch = stack_steps([pool[i % len(pool)] for i in range(loop_k)])
            after = AUTOTUNE_AFTER_WINDOWS
        else:
            fn = make_flax_train_step(model, opt)
            after = AUTOTUNE_AFTER
        i = left = 0
        while True:
            if tuner is None:
                if i == n:
                    break
            elif tuner.done:
                if left == after:
                    break
                left += 1
            key = tuner.trace_key() if tuner is not None else None
            before = metrics.exchange_totals()["buckets"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = fn(batch if loop_k else pool[i % len(pool)])
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t))
            out["losses"].append(loss.clone().reshape(-1))
            out["keys"].append(key)
            out["buckets"].append(metrics.exchange_totals()["buckets"]
                                  - before)
            out["planned"].append(len(opt.bucket_plan.buffers))
            i += 1
        out["calls"] = i
        out["trail"] = list(getattr(fn, "trail", ()))
        out["launches"] = {f: registry.launch_counts()[f]
                           for f in ("bn_bwd_reduce", "bn_bwd_dx")}
        out["losses"] = torch.cat(out["losses"])
        del fn
    finally:
        st.autotuner = None
    return out


def _launch_autotune(here: str) -> dict:
    """Phase 24 (e): ``python -m horovod_tpu_torch.run --probe --autotune``
    inside an LSF allocation of this host's one slot, with no ``-np``."""
    import socket
    env = dict(os.environ, PYTHONPATH=here, LSB_JOBID="24",
               LSB_MCPU_HOSTS=f"{socket.gethostname()} 1")
    for k in list(env):
        if k.startswith(("HOROVOD_AUTOTUNE", "HVD_TPU_AUTOTUNE")) or k in (
                "HVD_TPU_FORCE_CPU", "HOROVOD_RANK", "HOROVOD_SIZE",
                "HVD_TPU_RENDEZVOUS_FILE", "LSB_DJOB_RANKFILE"):
            env.pop(k)
    args = [sys.executable, "-m", "horovod_tpu_torch.run", "--probe",
            "--autotune", "-v", sys.executable, "-c", AUTOTUNE_WORKER]
    t = time.perf_counter()
    try:
        res = subprocess.run(args, env=env, cwd=here, capture_output=True,
                             text=True, timeout=AUTOTUNE_LAUNCH_TIMEOUT)
        code, text = res.returncode, res.stdout + res.stderr
    except subprocess.TimeoutExpired as e:
        code, text = "timeout", f"{e.stdout or ''}{e.stderr or ''}"
    return {"exit": code, "wall_s": time.perf_counter() - t,
            "worker_ok": "autotune worker rank 0 size 1 device cuda tuner "
                         "Autotuner" in text,
            "probe_ok": "# probe slot0: " in text, "tail": text[-1200:]}


def autotune_resnet(dev, card: str, phase8_step_ms: float) -> dict:
    """Phase 24 (see the module docstring).  Returns the BN launches of
    its runs."""
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import Autotuner
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.timeline import metrics

    here = os.path.dirname(os.path.abspath(__file__))
    fails = []
    bn_total = {"bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    tmp = tempfile.mkdtemp(prefix="hvd_autotune_smoke_")
    log_path = os.path.join(tmp, "autotune.csv")
    saved_env = {k: os.environ.get(k) for k in
                 list(AUTOTUNE_ENV) + ["HOROVOD_AUTOTUNE_LOG"]}
    os.environ.update(AUTOTUNE_ENV, HOROVOD_AUTOTUNE_LOG=log_path)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    _reset_counters()
    hvd.init()
    st = global_state()
    try:
        built_by_init = type(st.autotuner).__name__
        cfg = st.config
        model, _ = resnet50(dev, seed=0)
        named = list(model.named_parameters())
        trainable = [p for _, p in named]
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        pool = [images(gen, dev, 256, 1000) for _ in range(2)]

        def fresh():
            gc.collect()
            model.load_state_dict(init_state)
            return hvd.DistributedOptimizer(
                torch.optim.SGD(trainable, lr=0.1, momentum=0.9),
                named_parameters=named, compression=hvd.Compression.none)

        def count(run):
            for f in bn_total:
                bn_total[f] += run["launches"][f]

        def expected_buckets(key):
            return len(plan_buckets(trainable, key[0], reverse=True).buffers)

        # (a) The eager tuned run against as many untuned steps.
        samples_before = metrics.registry().counter(
            "horovod_autotune_samples_total").value
        tuner = Autotuner(cfg, steps_per_sample=AUTOTUNE_STEPS_PER_SAMPLE,
                          max_samples=AUTOTUNE_SAMPLES)
        opt = fresh()
        tuned = _autotune_run(model, opt, pool, tuner)
        tuned["state"] = _snapshot(model, opt)
        del opt
        opt = fresh()
        plain = _autotune_run(model, opt, pool, None, n=tuned["calls"])
        plain["state"] = _snapshot(model, opt)
        del opt
        count(tuned)
        count(plain)
        samples_total = metrics.registry().counter(
            "horovod_autotune_samples_total").value - samples_before
        diff = _bitwise(plain["state"], tuned["state"])
        losses_equal = torch.equal(plain["losses"], tuned["losses"])
        wrong_buckets = [(k[0], got, exch) for k, got, exch in zip(
            tuned["keys"], tuned["planned"], tuned["buckets"])
            if not got == exch == expected_buckets(k)]
        with open(log_path) as f:
            log_text = f.read()
        log_rows = [ln for ln in log_text.splitlines()
                    if ln and not ln.startswith(("fusion", "#"))]
        best = tuner._best
        scored = [t for t in tuned["trail"] if t[2]]
        entry_a = {
            "phase": "autotune_resnet", "part": "a_eager", "card": card,
            "batch": [256, 224, 224, 3], "built_by_init": built_by_init,
            "steps": tuned["calls"],
            "samples": [{"threshold": s[0], "chunk": s[5],
                         "score_bytes_per_s": s[-1]}
                        for s in tuner._samples],
            "chosen": {"threshold": best[0], "chunk": best[5]},
            "step_ms_chosen": _median(tuned["ms"][-AUTOTUNE_AFTER:]),
            "step_ms_default_64MiB": _median(plain["ms"][-AUTOTUNE_AFTER:]),
            "step_ms_tuning_median": _median(tuned["ms"][:-AUTOTUNE_AFTER]),
            "phase8_step_ms": phase8_step_ms,
            "buckets_by_threshold": sorted({(k[0], b) for k, b in zip(
                tuned["keys"], tuned["planned"])}),
            "scored_steps": len(scored), "unscored_steps": len(
                tuned["trail"]) - len(scored),
            "horovod_autotune_samples_total": samples_total,
            "log_rows": len(log_rows), "log_best": "# best," in log_text,
            "bitwise_vs_untuned": not diff and losses_equal,
            "differing": diff[:8], "wrong_buckets": wrong_buckets[:8],
            "bn_launches": tuned["launches"]}
        log(entry_a)
        if built_by_init != "Autotuner":
            fails.append(f"(a) init() built {built_by_init}")
        if diff or not losses_equal:
            fails.append(f"(a) not bitwise untuned: {diff[:8]}, losses "
                         f"equal {losses_equal}")
        if wrong_buckets:
            fails.append(f"(a) buckets not as planned: {wrong_buckets[:8]}")
        if len(tuner._samples) != AUTOTUNE_SAMPLES or \
                len(log_rows) != AUTOTUNE_SAMPLES or "# best," not in \
                log_text or samples_total != AUTOTUNE_SAMPLES:
            fails.append(f"(a) {len(tuner._samples)} samples, "
                         f"{len(log_rows)} log rows, counter "
                         f"{samples_total}")
        if len(scored) != AUTOTUNE_SAMPLES * AUTOTUNE_STEPS_PER_SAMPLE:
            fails.append(f"(a) {len(scored)} scored steps")
        for run in (tuned, plain):
            want = RESNET50_BN_SITES * run["calls"]
            if run["launches"] != {f: want for f in bn_total}:
                fails.append(f"(a) BN launches {run['launches']} != {want}")
        best_a = best
        del tuned, plain

        # (b) The loop tuned run against as many untuned windows.
        tuner_b = Autotuner(dataclasses.replace(cfg, autotune_log=None),
                            steps_per_sample=AUTOTUNE_STEPS_PER_SAMPLE,
                            max_samples=AUTOTUNE_LOOP_SAMPLES)
        opt = fresh()
        tuned = _autotune_run(model, opt, pool, tuner_b, loop_k=LOOP_K)
        tuned["state"] = _snapshot(model, opt)
        del opt
        opt = fresh()
        plain = _autotune_run(model, opt, pool, None, n=tuned["calls"],
                              loop_k=LOOP_K)
        plain["state"] = _snapshot(model, opt)
        count(tuned)
        count(plain)
        diff = _bitwise(plain["state"], tuned["state"])
        losses_equal = torch.equal(plain["losses"], tuned["losses"])
        trail = tuned["trail"]
        keys = sorted({k for k, _, _ in trail})
        captures = {str(k): [kind for kk, kind, _ in trail if kk == k]
                    .count("capture") for k in keys}
        warm_scored = [t for t in trail if t[1] != "replay" and t[2]]
        entry_b = {
            "phase": "autotune_resnet", "part": "b_loop", "card": card,
            "steps_per_execution": LOOP_K, "windows": tuned["calls"],
            "samples": [{"threshold": s[0], "chunk": s[5],
                         "score_bytes_per_s": s[-1]}
                        for s in tuner_b._samples],
            "chosen": {"threshold": tuner_b._best[0],
                       "chunk": tuner_b._best[5]},
            "captures_by_key": captures,
            "kinds": [kind for _, kind, _ in trail],
            "scored_windows": sum(1 for t in trail if t[2]),
            "eager_or_capture_scored": len(warm_scored),
            "step_ms_chosen_replay": tuned["ms"][-1] / LOOP_K,
            "step_ms_untuned_replay": plain["ms"][-1] / LOOP_K,
            "bitwise_vs_untuned_loop": not diff and losses_equal,
            "differing": diff[:8], "bn_launches": tuned["launches"]}
        log(entry_b)
        if diff or not losses_equal:
            fails.append(f"(b) not bitwise the untuned loop: {diff[:8]}, "
                         f"losses equal {losses_equal}")
        if len(keys) != AUTOTUNE_LOOP_SAMPLES or \
                set(captures.values()) != {1} or warm_scored:
            fails.append(f"(b) captures {captures}, scored warm windows "
                         f"{warm_scored}")
        for run in (tuned, plain):
            want = RESNET50_BN_SITES * LOOP_K * run["calls"]
            if run["launches"] != {f: want for f in bn_total}:
                fails.append(f"(b) BN launches {run['launches']} != {want}")
        del tuned, plain

        # (c) A warm start over (a)'s log.
        warm = Autotuner(cfg, steps_per_sample=AUTOTUNE_STEPS_PER_SAMPLE,
                         max_samples=AUTOTUNE_SAMPLES)
        entry_c = {"phase": "autotune_resnet", "part": "c_warm_start",
                   "done_at_construction": warm.done,
                   "same_best": warm._best == best_a,
                   "warm_rows": len(warm._samples)}
        log(entry_c)
        if not warm.done or warm._best != best_a:
            fails.append(f"(c) warm start {entry_c}")

        # (d) Sharded checkpoint of the state (a) and (b) trained.
        tree = {"model": model.state_dict(),
                "momentum": [s["momentum_buffer"]
                             for s in opt.state.values()]}
        like = {"model": {k: torch.zeros_like(v)
                          for k, v in tree["model"].items()},
                "momentum": [torch.zeros_like(m) for m in tree["momentum"]]}
        nbytes = sum(v.numel() * v.element_size() for v in
                     list(tree["model"].values()) + tree["momentum"])
        ck_ms = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ck_ms[name] = 1e3 * (time.perf_counter() - t)
            return r

        sdir = os.path.join(tmp, "sharded")
        timed("save_sharded", lambda: hvd.save_checkpoint_sharded(
            sdir, tree, step=24))
        got_s, step_s = timed("restore_sharded",
                              lambda: hvd.restore_checkpoint_sharded(
                                  sdir, like))
        npz = hvd.checkpoint_path(tmp, 24)
        timed("save_npz", lambda: hvd.save_checkpoint(npz, tree, step=24))
        got_n, step_n = timed("restore_npz",
                              lambda: hvd.restore_checkpoint(npz, like))

        def same(got):
            return all(torch.equal(got["model"][k], v)
                       for k, v in tree["model"].items()) and all(
                torch.equal(g, w) for g, w in zip(got["momentum"],
                                                  tree["momentum"]))

        entry_d = {"phase": "autotune_resnet", "part": "d_checkpoint",
                   "card": card, "bytes": nbytes,
                   "tensors": len(tree["model"]) + len(tree["momentum"]),
                   "ms": ck_ms, "sharded_bitwise": same(got_s),
                   "npz_bitwise": same(got_n),
                   "steps": [step_s, step_n],
                   "on_device": all(v.device.type == "cuda" for v in
                                    got_s["model"].values())}
        log(entry_d)
        if not (entry_d["sharded_bitwise"] and entry_d["npz_bitwise"]
                and entry_d["on_device"] and step_s == step_n == 24):
            fails.append(f"(d) checkpoints {entry_d}")
        del opt, model, named, trainable, init_state, pool, tree, like, \
            got_s, got_n
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
        hvd.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) The launcher: --probe --autotune, -np from LSF.
    entry_e = {"phase": "autotune_resnet", "part": "e_launcher",
               **_launch_autotune(here)}
    log(entry_e)
    if entry_e["exit"] != 0 or not entry_e["worker_ok"] or \
            not entry_e["probe_ok"]:
        fails.append(f"(e) launcher: {entry_e}")
    if fails:
        raise AssertionError("autotune_resnet: " + "; ".join(fails))
    return bn_total


JOIN_LAUNCH_TIMEOUT = 240
EAGER_JOIN_STEPS = 5            # timed steps of (a), after one warm-up
EAGER_JOIN_EXTRA = 3            # (a)'s batched run continues for (c):
#                                 its nine steps are (c)'s three samples
#                                 of 1 + 2 steps


def _join_launch(here: str) -> dict:
    """Phase 25 (d): the port's ``join_check.py`` at ``-np 2 --cpu``."""
    env = dict(os.environ, PYTHONPATH=here)
    for k in list(env):
        if k.startswith(("HOROVOD_AUTOTUNE", "HVD_TPU_AUTOTUNE")) or k in (
                "HVD_TPU_NATIVE_CORE", "HOROVOD_RANK", "HOROVOD_SIZE",
                "HVD_TPU_RENDEZVOUS_FILE", "HOROVOD_CHAOS"):
            env.pop(k)
    args = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
            "--cpu", sys.executable, "-m",
            "horovod_tpu_torch.examples.join_check"]
    t = time.perf_counter()
    try:
        res = subprocess.run(args, env=env, cwd=here, capture_output=True,
                             text=True, timeout=JOIN_LAUNCH_TIMEOUT)
        code, text = res.returncode, res.stdout + res.stderr
    except subprocess.TimeoutExpired as e:
        code, text = "timeout", f"{e.stdout or ''}{e.stderr or ''}"
    return {"exit": code, "wall_s": time.perf_counter() - t,
            "join_ok": [f"rank {r}: join OK last=1" in text
                        for r in range(2)],
            "join2_ok": [f"rank {r}: join2 OK last=1" in text
                         for r in range(2)], "tail": text[-1500:]}


def _torch_steps(bench, steps: int, snap_at: int = 0, tuner=None,
               batcher=None, nbytes: int = 0) -> dict:
    """``steps`` steps of the torch-idiom bench: each step's loss and ms,
    the host ms in the optimizer's ``synchronize()`` (the batched path:
    the flush, the native thread's callback and the waits), the
    parameters at the end and after step ``snap_at``, and under
    ``tuner`` each step's record and the batcher's knobs after it."""
    losses, times, knobs, snap, sync_s = [], [], [], None, []
    opt = bench.optimizer
    inner = opt.synchronize

    def timed_sync():            # host time in the exchange's wait
        t0 = time.perf_counter()
        try:
            return inner()
        finally:
            sync_s.append(time.perf_counter() - t0)
    opt.synchronize = timed_sync
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(bench.step().item())
        times.append(time.perf_counter() - t)
        if tuner is not None:
            tuner.record_step(times[-1], nbytes)
            knobs.append((tuner.cycle_time_ms(), tuner.fusion_threshold(),
                          batcher.cycle_ms, batcher.fusion_bytes,
                          batcher.batches()))
        if i + 1 == snap_at:
            snap = {n: p.detach().clone()
                    for n, p in bench.model.named_parameters()}
    del opt.synchronize
    return {"losses": losses, "step_ms_each": [1e3 * t for t in times],
            "sync_ms_each": [1e3 * t for t in sync_s],
            "knobs": knobs, "snap": snap,
            "params": {n: p.detach().clone()
                       for n, p in bench.model.named_parameters()}}


def _differ(a: dict, b: dict) -> list:
    return [n for n, t in a.items() if not torch.equal(t, b[n])]


def _eager_ops(dev, shapes, fails: list) -> dict:
    """Phase 25 (b): the eager ops at world 1, each held exactly."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import eager
    g = torch.Generator(device=dev).manual_seed(25)
    xs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    out = {}
    for forced in (False, True):
        saved = eager._defer_applies
        if forced:        # the fused deferred flush, as the tests force it
            eager._defer_applies = lambda ps: True
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            hs = [hvd.allreduce_async(x, op=hvd.Average) for x in xs]
            got = [hvd.synchronize(h) for h in hs]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        finally:
            eager._defer_applies = saved
        bad = sum(not torch.equal(a, b) for a, b in zip(got, xs))
        if bad:
            fails.append(f"{bad} allreduce_async results differ "
                         f"(deferred={forced})")
        out["deferred" if forced else "immediate"] = {
            "ms": ms, "fuse_stats": eager.deferred_fuse_stats()}
    x = torch.randn(37, 5, generator=g, device=dev)
    _exact(fails, "allgatherv", hvd.allgatherv(x), x)
    datas, recv = hvd.alltoallv([x], [[37]])
    _exact(fails, "alltoallv", datas[0], x)
    if recv[0].tolist() != [37]:
        fails.append(f"alltoallv received splits {recv[0].tolist()}")
    row, row_splits = hvd.alltoallv_row(x, [37])
    _exact(fails, "alltoallv_row", row, x)
    _exact(fails, "local_result", hvd.local_result(x), x[None])
    if hvd.local_rank_count() != 1:
        fails.append(f"local_rank_count {hvd.local_rank_count()}")
    last = hvd.join()
    if last != -1:
        fails.append(f"join() returned {last} at world 1")
    out.update(ops=len(xs), join=last, local_rank_count=1,
               eager_op_stats=eager.eager_op_stats())
    return out


def eager_join(dev, card: str) -> dict:
    """Phase 25 (module docstring).  Returns the BN launch counts of
    (a)'s nine batched steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import Autotuner
    from horovod_tpu_torch.collectives import batching
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples import torch_resnet50 as ex
    from horovod_tpu_torch.ops import registry

    here = os.path.dirname(os.path.abspath(__file__))
    fails = []
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    args = ex.parse_args([])
    hvd.init()
    st = global_state()
    base = st.config

    def bench(native: bool):
        st.config = dataclasses.replace(base, native_core=native,
                                        cycle_time=1.0)
        return ex.setup(args)

    # (a) batched, then planned, from the same weights (setup's seed).
    n_a = 1 + EAGER_JOIN_STEPS
    n_all = n_a + EAGER_JOIN_EXTRA
    b = bench(True)
    batcher = batching.batcher()
    shapes = [tuple(p.shape) for p in b.model.parameters()]
    nbytes = 4 * sum(p.numel() for p in b.model.parameters())
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    cut0 = batcher.batches()
    batched = _torch_steps(b, n_all, snap_at=n_a)
    counts = registry.launch_counts()
    cuts = (batcher.batches() - cut0) / n_all
    del b
    gc.collect()
    p = bench(False)
    planned = _torch_steps(p, n_a)
    del p
    gc.collect()
    b_ms, p_ms = batched["step_ms_each"][1:n_a], planned["step_ms_each"][1:]
    log({"phase": "eager_join_a", "card": card, "steps": EAGER_JOIN_STEPS,
         "batched_step_ms": sum(b_ms) / len(b_ms),
         "batched_step_ms_each": b_ms,
         "planned_step_ms": sum(p_ms) / len(p_ms),
         "planned_step_ms_each": p_ms,
         "batched_sync_ms_each": batched["sync_ms_each"][1:n_a],
         "planned_sync_ms_each": planned["sync_ms_each"][1:],
         "native_batches_per_step": cuts,
         "deterministic": batcher.deterministic,
         "cycle_ms": batcher.cycle_ms, "fusion_bytes": batcher.fusion_bytes,
         "losses_batched": batched["losses"],
         "losses_planned": planned["losses"],
         "bn_launches_per_step": {k: counts[k] / n_all
                                  for k in ("bn_bwd_reduce", "bn_bwd_dx")}})
    if batched["losses"][:n_a] != planned["losses"]:
        fails.append(f"batched losses {batched['losses'][:n_a]} != "
                     f"planned {planned['losses']}")
    moved = _differ(planned["params"], batched["snap"])
    if moved:
        fails.append(f"{len(moved)} parameters differ batched vs planned")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != RESNET50_BN_SITES * n_all:
            fails.append(f"{f} launches {counts[f]} != "
                         f"{RESNET50_BN_SITES * n_all}")
    if not batcher.deterministic:
        fails.append("the batcher is not deterministic on the GPU")
    if not all(np.isfinite(batched["losses"])):
        fails.append("a loss is not finite")

    # (b) the eager ops.
    ops = _eager_ops(dev, shapes, fails)
    log({"phase": "eager_join_b", "card": card, **ops})

    # (c) the autotuner on the batched path; the batcher is deterministic
    # on the GPU, so the cycle axis stays pinned.
    tuner = Autotuner(dataclasses.replace(base, autotune=True,
                                          autotune_log=None,
                                          native_core=True, cycle_time=1.0),
                      steps_per_sample=2)
    st.autotuner = tuner
    try:
        tb = bench(True)
        tuned = _torch_steps(tb, n_all, tuner=tuner, batcher=batcher,
                           nbytes=nbytes)
        del tb
        gc.collect()
    finally:
        st.autotuner = None
    reached = all(k[0] == k[2] == 1.0 and k[1] == k[3]
                  for k in tuned["knobs"])
    if tuned["losses"] != batched["losses"]:
        fails.append(f"tuned losses {tuned['losses']} != untuned "
                     f"{batched['losses']}")
    diff = _differ(tuned["params"], batched["params"])
    if diff:
        fails.append(f"{len(diff)} parameters differ tuned vs untuned")
    if tuner.tunes_cycle or not reached:
        fails.append(f"cycle axis open {tuner.tunes_cycle} on a "
                     f"deterministic batcher, batcher followed the samples "
                     f"{reached}: {tuned['knobs']}")
    log({"phase": "eager_join_c", "card": card,
         "cycle_axis": sorted({c for _, c, *_ in tuner.grid}),
         "samples_threshold_cycle_score": [
             (smp[0], smp[1], smp[-1]) for smp in tuner._samples],
         "knobs_each_step": tuned["knobs"],
         "tuned_step_ms_each": tuned["step_ms_each"]})

    # (d) the launcher's two-rank join drill.
    launch = _join_launch(here)
    log({"phase": "eager_join_d", **launch})
    if launch["exit"] != 0 or not all(launch["join_ok"]) or \
            not all(launch["join2_ok"]):
        fails.append(f"join_check -np 2: exit {launch['exit']}, "
                     f"{launch['join_ok']} {launch['join2_ok']}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        cudnn
    st.config = base
    if fails:
        raise AssertionError("eager_join: " + "; ".join(fails))
    hvd.shutdown()
    return counts


# ---------------------------------------------------------------------------
# Phase 26: the int8 frozen base, remat, LoRA banks and speculation
# ---------------------------------------------------------------------------


LORA_ADAPTERS = 3      # (c): adapters in the bank
LORA_REQUESTS = 6      # (c): requests, the adapter ids cycling
LORA_STD = 0.02        # (c): every adapter leaf from N(0, 0.02)
MERGE_TOL = 1e-4       # (c): f32 banked vs merge_lora, of max |logit|
SPEC_K = 4             # (d): drafts a round; the verify width is 5


def lora_int8_model(cfg, dev, seed: int, nonzero_b: bool,
                    remat: bool = False):
    """:func:`lora_model` with the frozen base at int8 (the f32 draw of
    ``seed``, quantized per output channel)."""
    from horovod_tpu_torch.models import (LlamaLM, freeze_base,
                                          init_llama_params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_llama_params(cfg, generator=gen, device=dev, lora_rank=8,
                               base_dtype="int8")
    if nonzero_b:
        for name, t in params.items():
            if name.endswith(".lora_b"):
                t.normal_(0.0, 0.02, generator=gen)
    model = LlamaLM.from_params(cfg, params, dtype=torch.bfloat16,
                                lora_rank=8, remat=remat, base_dtype="int8")
    return model, freeze_base(model)


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def check_int8_grad(dev, fails: list) -> None:
    """(a): one loss and backward at full width, 2 layers, int8 base,
    through the kernels, through the plain attention, and through the
    kernels under remat."""
    from horovod_tpu_torch.models import LLAMA3_8B
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.training import next_token_loss

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model, named = lora_int8_model(cfg, dev, seed=4, nonzero_b=True)
    tokens = batch(cfg, dev, seed=1)
    runs = {}
    for key, ref, remat in (("kernels", False, False),
                            ("plain", True, False), ("remat", False, True)):
        model.remat = remat
        model.zero_grad(set_to_none=True)
        registry.reset_launch_counts()
        loss = next_token_loss(model(tokens, force_reference=ref), tokens)
        loss.backward()
        torch.cuda.synchronize()
        runs[key] = (loss.item(), {n: p.grad.clone() for n, p in named},
                     registry.launch_counts())
    (loss_k, g_k, c_k), (loss_r, g_r, c_r), (loss_m, g_m, c_m) = (
        runs["kernels"], runs["plain"], runs["remat"])
    worst = max(((g_k[n] - g_r[n]).abs().max().item()
                 / max(g_r[n].abs().max().item(), 1e-30), n) for n in g_r)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    remat_bitwise = loss_m == loss_k and all(torch.equal(g_m[n], g_k[n])
                                             for n in g_k)
    log({"phase": "lora_int8_grad", "layers": cfg.num_layers,
         "lora_rank": 8, "base": "int8", "tensors": len(g_r),
         "loss": loss_k, "loss_plain": loss_r, "loss_remat": loss_m,
         "loss_rel_err": loss_rel, "worst_grad_rel_err": worst[0],
         "worst_grad": worst[1], "tol": BF16_TOL,
         "remat_bitwise": remat_bitwise, "launches": c_k,
         "launches_plain": c_r, "launches_remat": c_m})
    if not (loss_rel <= 1e-2 and worst[0] <= BF16_TOL
            and all(torch.isfinite(g).all() for g in g_k.values())):
        fails.append("(a) int8 LoRA gradients through the kernels "
                     "disagree with the plain attention")
    if not remat_bitwise:
        fails.append("(a) the remat step is not bitwise the plain step")
    for c, fwd in ((c_k, 1), (c_m, 2)):
        if (c["flash"], c["flash_bwd_dq"], c["flash_bwd_dkv"]) != (
                fwd * cfg.num_layers, cfg.num_layers, cfg.num_layers):
            fails.append(f"(a) launches {c}")
    if any(c_r.values()):
        fails.append(f"(a) the plain run launched {c_r}")
    del model, named, runs, g_k, g_r, g_m


def train_int8(dev, card: str, bf16_run: dict, fails: list,
               total: dict) -> None:
    """(b): the full-depth int8 + remat LoRA fine-tune, then the same
    from the same weights without remat, beside phase 6's bf16 base."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import LLAMA3_8B

    cfg = LLAMA3_8B
    hvd.init()
    for remat in (True, False):
        t0 = time.perf_counter()
        model, named = lora_int8_model(cfg, dev, seed=0, nonzero_b=False,
                                       remat=remat)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        base_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters() if not p.requires_grad)
        run = lora_steps(hvd, cfg, dev, model, named)
        log({"phase": "lora_int8_train", "card": card, "remat": remat,
             "init_seconds": init_s, "base_bytes": base_bytes,
             "batch": [2, 2048], **run,
             "bf16_base_step_ms": bf16_run["step_ms"],
             "bf16_base_peak_mem_bytes": bf16_run["peak_mem_bytes"]})
        fails += [f"(b) remat={remat}: {f}" for f in lora_run_fails(
            run, (2 if remat else 1) * cfg.num_layers, cfg.num_layers)]
        _add_counts(total, run["launches"])
        del model, named, run
        free_device()
    hvd.shutdown()


def serve_banks(dev, card: str, fails: list, total: dict) -> None:
    """(c): three adapters in one bank over the bf16 base, six requests,
    against single-adapter engines and the merge_lora weights."""
    from horovod_tpu_torch.examples.llama_lora import random_adapters
    from horovod_tpu_torch.models import (LLAMA3_8B, init_llama_params,
                                          merge_lora)
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.serving import (LoadSpec, Request, ServingEngine,
                                           generate, prefill_forward,
                                           stack_adapters)

    cfg, bf16 = LLAMA3_8B, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=bf16, device=dev,
                               lora_rank=8)
    adapters = random_adapters(params, LORA_ADAPTERS, seed=100,
                               std=LORA_STD)
    banks = stack_adapters(adapters)
    geom = dict(slots=8, page_size=16, max_len=1024, dtype=bf16, device=dev)
    load = dict(num_requests=LORA_REQUESTS, prompt_lens=(37, 512),
                output_lens=(32,), vocab_size=cfg.vocab_size,
                num_adapters=LORA_ADAPTERS, seed=1)
    eng = ServingEngine(cfg, params, adapters=banks, **geom)
    eng.serve([Request(rid=-1, prompt=np.arange(16), max_new_tokens=2)])
    reqs = generate(LoadSpec(**load))
    registry.reset_launch_counts()
    rep = eng.serve(reqs).as_dict()
    counts = registry.launch_counts()
    _add_counts(total, counts)
    del eng
    streams = {r.rid: list(r.tokens) for r in reqs}
    if rep["completed"] != LORA_REQUESTS:
        fails.append(f"(c) completed {rep['completed']}")
    if counts["flash"] != cfg.num_layers * rep["prefills"] or \
            counts["flash_decode"] != cfg.num_layers * rep["decode_steps"]:
        fails.append(f"(c) launches {counts} for {rep['prefills']} "
                     f"prefills and {rep['decode_steps']} decode steps")
    per_adapter = []
    for j, adapter in enumerate(adapters):
        ref = [r for r in generate(LoadSpec(**load)) if r.adapter_id == j]
        for r in ref:
            r.adapter_id = 0
        tree = {**params, **adapter}
        ServingEngine(cfg, tree, **geom).serve(ref)
        same = all(r.tokens == streams[r.rid] for r in ref)
        # The first request's first-token logits: the banked prefill
        # against the merge_lora weights' prefill.  Checked in f32
        # compute over the same bf16-stored base (the merged kernels
        # f32), where the two differ by f32 roundoff alone (MERGE_TOL);
        # two bf16 computations 32 layers deep differ by bf16 noise near
        # BF16_TOL (phase 4's kernel-vs-plain pair reads ~1.7 % of max
        # |logit|), and the merge rounds every kernel to bf16 once
        # more, so the bf16 pair is logged beside it.
        prompt = torch.tensor(ref[0].prompt, device=dev)[None]
        errs = {}
        for dt in (torch.float32, bf16):
            got = prefill_forward(params, cfg, prompt, dtype=dt,
                                  adapters=banks, adapter_id=j)[0][0, -1]
            merged = merge_lora({n: (t.to(dt) if n.endswith(".kernel")
                                     else t) for n, t in tree.items()})
            want = prefill_forward(merged, cfg, prompt, dtype=dt)[0][0, -1]
            del merged
            errs[str(dt)[6:]] = {
                "err": (got - want).abs().max().item(),
                "tol": (MERGE_TOL if dt == torch.float32 else BF16_TOL)
                * want.abs().max().item(),
                "finite": bool(torch.isfinite(got).all()),
                "argmax_agrees": int(got.argmax()) == int(want.argmax())}
            free_device()
        err, tol = errs["float32"]["err"], errs["float32"]["tol"]
        per_adapter.append({"adapter": j, "requests": len(ref),
                            "streams_equal": same,
                            "first_logits_vs_merge_lora": errs})
        if not same:
            fails.append(f"(c) adapter {j}: banked streams differ from the "
                         "single-adapter engine's")
        if not (err <= tol and errs["float32"]["finite"]):
            fails.append(f"(c) adapter {j}: first-token logits {err} from "
                         f"merge_lora's (tol {tol})")
        free_device()
    log({"phase": "lora_banks_serve", "card": card, **rep,
         "launches": counts, "adapters": per_adapter,
         "distinct_streams": len({tuple(t) for t in streams.values()})})
    del params, adapters, banks


def _all_accepted(reqs, k: int) -> tuple:
    """Spec rounds a slot and accepted drafts if every draft agrees: a
    round emits ``min(k + 1, tokens left)``, the first token came from
    the prefill."""
    rounds = accepted = 0
    for r in reqs:
        left = r.max_new_tokens - 1
        while left > 0:
            emit = min(k + 1, left)
            rounds, accepted, left = rounds + 1, accepted + emit - 1, \
                left - emit
    return rounds, accepted


def serve_spec(dev, card: str, plain: dict, fails: list,
               total: dict) -> None:
    """(d): phase 4's cell again, speculating with the n-gram drafter and
    with a model drafter over the target's own weights."""
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.serving import (LoadSpec, ModelDrafter,
                                           NgramDrafter, Request,
                                           ServingEngine, generate)

    cfg, bf16, width = LLAMA3_8B, torch.bfloat16, SPEC_K + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=bf16, device=dev)
    base = plain["report"]
    out = {"plain": {k: base[k] for k in (
        "tokens_per_s", "token_latency_p50_s", "token_latency_p99_s",
        "ttft_p50_s", "decode_steps")}}
    for name in ("ngram", "model"):
        drafter = NgramDrafter() if name == "ngram" else ModelDrafter(
            cfg, params, dtype=bf16, device=dev, **SERVE_GEOM)
        eng = ServingEngine(cfg, params, device=dev, dtype=bf16,
                            spec_decode=True, spec_k=SPEC_K,
                            drafter=drafter, **SERVE_GEOM)
        eng.serve([Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                           max_new_tokens=2)])
        reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
        d_steps = getattr(drafter, "steps", 0)
        d_prefills = getattr(drafter, "prefills", 0)
        registry.reset_launch_counts()
        rep = eng.serve(reqs).as_dict()
        counts = registry.launch_counts()
        _add_counts(total, counts)
        d_steps = getattr(drafter, "steps", 0) - d_steps
        d_prefills = getattr(drafter, "prefills", 0) - d_prefills
        del eng, drafter
        free_device()
        rounds = rep["spec_rounds"]
        want_decode = cfg.num_layers * (rep["decode_steps"] - rounds
                                        + width * rounds + d_steps)
        want_flash = cfg.num_layers * (rep["prefills"] + d_prefills)
        same = all(r.tokens == plain["streams"][r.rid] for r in reqs)
        out[name] = {**{k: rep[k] for k in (
            "tokens_per_s", "token_latency_p50_s", "token_latency_p99_s",
            "ttft_p50_s", "decode_steps", "spec_rounds", "proposed_tokens",
            "accepted_tokens", "acceptance_rate", "wall_s", "completed")},
            "drafter_steps": d_steps, "drafter_prefills": d_prefills,
            "streams_equal_plain": same, "launches": counts}
        if rep["completed"] != len(reqs) or not same:
            fails.append(f"(d) {name}: streams differ from phase 4's plain "
                         "decode")
        if counts["flash_decode"] != want_decode or \
                counts["flash"] != want_flash:
            fails.append(f"(d) {name}: launches {counts}, want "
                         f"flash_decode {want_decode}, flash {want_flash}")
        if name == "model":
            slot_rounds, accepted = _all_accepted(reqs, SPEC_K)
            if (rep["proposed_tokens"], rep["accepted_tokens"]) != (
                    SPEC_K * slot_rounds, accepted):
                fails.append(
                    f"(d) model drafter: {rep['accepted_tokens']} of "
                    f"{rep['proposed_tokens']} accepted, every draft "
                    f"agreeing gives {accepted} of {SPEC_K * slot_rounds}")
    log({"phase": "spec_serve", "card": card, "spec_k": SPEC_K, **out})
    del params


def lora_int8_serve(dev, card: str, train_run: dict,
                    serve_run: dict) -> dict:
    """Phase 26 (module docstring).  Returns the attention kernels'
    launches on (b)-(d)'s runs."""
    fails: list = []
    total: dict = {}
    check_int8_grad(dev, fails)
    free_device()
    train_int8(dev, card, train_run, fails, total)
    free_device()
    serve_banks(dev, card, fails, total)
    free_device()
    serve_spec(dev, card, serve_run, fails, total)
    if fails:
        raise AssertionError("lora_int8_serve: " + "; ".join(fails))
    return total


# ---------------------------------------------------------------------------
# Phase 27: the serving rest -- chunked prefill, fp8 pages, the prefix
# cache, the KV wire and the disaggregated fleet
# ---------------------------------------------------------------------------


REST_CHUNK = 512          # (a), (c): the prefill chunk
# (a): seed 1 is the first seed whose eight draws hold all three buckets
# (3 x 512, 3 x 2048, 2 x 4096 tokens); seed 0 draws no 4096.
REST_LONG = dict(num_requests=8, seed=1)
REST_PREFIX = dict(prefix_lens=(1024,), num_prefixes=2, prompt_lens=(16, 64),
                   output_lens=(16,), num_requests=16)
REST_FLEET = dict(num_requests=8, prompt_lens=(37, 512), output_lens=(16, 32),
                  seed=2)


def _rest_max_len(reqs, page: int = 16) -> int:
    need = max(r.prompt_len + r.max_new_tokens for r in reqs)
    return -(-need // page) * page


def _streams(reqs) -> dict:
    return {r.rid: list(r.tokens) for r in reqs}


def _agreement(reqs, streams: dict) -> float:
    return sum(list(r.tokens) == streams[r.rid] for r in reqs) / len(reqs)


def _warm(eng) -> None:
    """One short request (cuBLAS handles, the allocator, the kernels)."""
    from horovod_tpu_torch.serving import Request
    eng.serve([Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                       max_new_tokens=2)])


def _rest_serve(eng, reqs) -> tuple:
    """A warm-up request, then one run with the launch counters set to 0
    just before; returns (report dict, launch counts)."""
    from horovod_tpu_torch.ops import registry
    _warm(eng)
    registry.reset_launch_counts()
    rep = eng.serve(reqs).as_dict()
    return rep, registry.launch_counts()


def _rest_launch_fails(what: str, rep: dict, counts: dict, layers: int,
                       decode: str = "flash_decode") -> list:
    """The kernels a serve run must have launched: the flash forward once
    a layer a prefill forward (whole, prefix tail or chunk), the decode
    kernel (or its e4m3 variant) once a layer a step."""
    out = []
    if counts["flash"] != layers * rep["prefill_forwards"]:
        out.append(f"{what}: flash {counts['flash']} != {layers} x "
                   f"{rep['prefill_forwards']} prefill forwards")
    if counts[decode] != layers * rep["decode_steps"]:
        out.append(f"{what}: {decode} {counts[decode]} != {layers} x "
                   f"{rep['decode_steps']} steps")
    other = "flash_decode_fp8" if decode == "flash_decode" else \
        "flash_decode"
    if counts[other]:
        out.append(f"{what}: {other} launched {counts[other]} times")
    return out


def rest_chunked(cfg, params, dev, card: str, fails: list,
                 total: dict) -> None:
    """(a): ``long_prompt_spec`` whole and with ``prefill_chunk=512``;
    the last chunk's logits against the whole prompt's."""
    from horovod_tpu_torch.serving import (ServingEngine, generate,
                                           long_prompt_spec,
                                           prefill_forward)
    bf16 = torch.bfloat16
    spec = long_prompt_spec(vocab_size=cfg.vocab_size, **REST_LONG)
    first = generate(spec)
    geom = dict(slots=8, page_size=16, max_len=_rest_max_len(first),
                dtype=bf16, device=dev)
    runs = {}
    for name, chunk in (("whole", 0), ("chunked", REST_CHUNK)):
        reqs = generate(spec)
        eng = ServingEngine(cfg, params, prefill_chunk=chunk, **geom)
        rep, counts = _rest_serve(eng, reqs)
        leaked = eng.cache.release_all()
        balanced = eng.cache.refcounts_balanced()
        del eng
        free_device()
        _add_counts(total, counts)
        runs[name] = (rep, reqs)
        fails += _rest_launch_fails(f"(a) {name}", rep, counts,
                                    cfg.num_layers)
        if rep["completed"] != len(reqs) or leaked or not balanced:
            fails.append(f"(a) {name}: completed {rep['completed']}, "
                         f"leaked {leaked}, balanced {balanced}")
        log({"phase": "rest_chunked", "run": name, "card": card,
             "prefill_chunk": chunk, "max_len": geom["max_len"],
             "prompt_lens": [r.prompt_len for r in reqs], **rep,
             "launches": counts})
    (wrep, wreqs), (crep, creqs) = runs["whole"], runs["chunked"]
    if not crep["prefill_chunks"]:
        fails.append("(a) no prompt was chunked")
    # The longest prompt's last logits, chunked against whole.
    longest = max(first, key=lambda r: r.prompt_len)
    prompt = torch.tensor(longest.prompt, dtype=torch.long, device=dev)[None]
    want = prefill_forward(params, cfg, prompt, dtype=bf16)[0][0, -1]
    past = got = None
    for lo in range(0, prompt.shape[1], REST_CHUNK):
        logits, kl, vl = prefill_forward(
            params, cfg, prompt[:, lo:lo + REST_CHUNK], dtype=bf16,
            past=past)
        past, got = (kl, vl), logits[0, -1].clone()
        del logits
    del past
    err = (got - want).abs().max().item()
    tol = BF16_TOL * want.abs().max().item()
    agree = _agreement(creqs, _streams(wreqs))
    log({"phase": "rest_chunked_logits", "card": card,
         "prompt_len": int(prompt.shape[1]), "chunk": REST_CHUNK,
         "max_abs_err": err, "tol": tol,
         "argmax_agrees": int(got.argmax()) == int(want.argmax()),
         "stream_agreement": agree,
         "ttft_p50_s": [wrep["ttft_p50_s"], crep["ttft_p50_s"]],
         "ttft_p99_s": [wrep["ttft_p99_s"], crep["ttft_p99_s"]],
         "tokens_per_s": [wrep["tokens_per_s"], crep["tokens_per_s"]]})
    if not (err <= tol and bool(torch.isfinite(got).all())):
        fails.append(f"(a) last-chunk logits {err} from the whole "
                     f"prompt's (tol {tol})")


def rest_fp8(cfg, params, dev, card: str, plain: dict, fails: list,
             total: dict) -> None:
    """(b): one decode step over compressed cold pages against the plain
    step over the dequantised pool, bitwise; then phase 4's load on a
    ``kv_compress`` engine whose cold pages are compressed before every
    step."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.serving import (CacheConfig, LoadSpec,
                                           PagedKVCache, ServingEngine,
                                           build_decode_step, generate,
                                           prefill_forward)
    bf16, layers = torch.bfloat16, cfg.num_layers
    reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
    slots, ps, max_len = (SERVE_GEOM["slots"], SERVE_GEOM["page_size"],
                          SERVE_GEOM["max_len"])
    pps = max_len // ps
    cache = PagedKVCache(CacheConfig(
        num_layers=layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, slots=slots, page_size=ps, max_len=max_len,
        dtype="bfloat16", compress=True), device=dev)
    for slot, r in enumerate(reqs):
        _, kl, vl = prefill_forward(
            params, cfg, torch.tensor(r.prompt, device=dev)[None],
            dtype=bf16)
        cache.write_prefill(slot, kl[:, 0], vl[:, 0])
        del kl, vl
    # Room for the step's write first: the pages compress_cold frees
    # then stay free, and the plain pool below can hold their
    # dequantised rows.
    lens = cache.lengths.copy()
    for s in range(slots):
        cache.reserve(s, int(lens[s]) + 1, writable_from=int(lens[s]))
    old = cache.page_table.copy()
    moved = sum(cache.compress_cold(s) for s in range(slots))
    cm = cache.comp_mask.copy()
    plain_table = cache.page_table.copy()
    plain_table[cm] = old[cm]
    pids = torch.tensor(old[cm], dtype=torch.long, device=dev)
    cps = torch.tensor(cache.cpage_table[cm], dtype=torch.long, device=dev)
    deq_k, deq_v = cache.k.clone(), cache.v.clone()
    deq_k[:, pids] = cache.dequantized("k", cps)
    deq_v[:, pids] = cache.dequantized("v", cps)
    tok = torch.tensor([int(r.prompt[-1]) for r in reqs], device=dev)
    pos = cache.lengths_device().long()
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    registry.reset_launch_counts()
    got, _, _ = build_decode_step(
        cfg, slots=slots, page_size=ps, pages_per_slot=pps, dtype=bf16,
        compress=True)(params, cache.k, cache.v, tok, pos,
                       cache.table_device(), active,
                       *cache.compress_operands())
    want, _, _ = build_decode_step(
        cfg, slots=slots, page_size=ps, pages_per_slot=pps, dtype=bf16)(
        params, deq_k, deq_v, tok, pos,
        torch.tensor(plain_table, dtype=torch.int32, device=dev), active)
    torch.cuda.synchronize()
    step_counts = registry.launch_counts()
    bitwise = torch.equal(got, want)
    log({"phase": "rest_fp8_step", "card": card, "slots": slots,
         "lengths": [int(n) for n in lens], "compressed_pages": moved,
         "resident_bytes": cache.resident_bytes,
         "bitwise_plain_step_on_dequantised_pool": bitwise,
         "launches": step_counts})
    if not bitwise or not moved:
        fails.append(f"(b) the compressed step is not bitwise the plain "
                     f"step over the dequantised pool ({moved} pages)")
    if (step_counts["flash_decode_fp8"], step_counts["flash_decode"]) != (
            layers, layers):
        fails.append(f"(b) step launches {step_counts}")
    del cache, deq_k, deq_v, got, want
    free_device()

    class ColdSweep(ServingEngine):
        """Compresses every decode slot's cold pages before each step:
        the page pressure of a full pool, on demand."""
        peak = 0

        def decode_once(self, st, now):
            for slot in self._decode_slots():
                self.cache.compress_cold(slot)
            self.peak = max(self.peak, self.cache.compressed_pages)
            return super().decode_once(st, now)

    eng = ColdSweep(cfg, params, device=dev, dtype=bf16, kv_compress=True,
                    **SERVE_GEOM)
    reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
    rep, counts = _rest_serve(eng, reqs)
    _add_counts(total, counts)
    leaked = eng.cache.release_all()
    ok_pool = (leaked == 0 and eng.cache.live_pages == 0
               and eng.cache.compressed_pages == 0
               and eng.cache.refcounts_balanced())
    agree = _agreement(reqs, plain["streams"])
    log({"phase": "rest_fp8_serve", "card": card, **rep,
         "peak_compressed_pages": eng.peak, "released_clean": ok_pool,
         "stream_agreement_with_phase4": agree, "launches": counts,
         "phase4_tokens_per_s": plain["report"]["tokens_per_s"]})
    fails += _rest_launch_fails("(b) serve", rep, counts, layers,
                                decode="flash_decode_fp8")
    if rep["completed"] != len(reqs) or not eng.peak or not ok_pool:
        fails.append(f"(b) serve: completed {rep['completed']}, peak "
                     f"compressed pages {eng.peak}, clean {ok_pool}")
    del eng


def rest_prefix(cfg, params, dev, card: str, fails: list,
                total: dict) -> None:
    """(c): a prefix-shared load with the prefix cache on and off, both
    chunking at 512."""
    from horovod_tpu_torch.serving import (ServingEngine, generate,
                                           prefix_spec)
    spec = prefix_spec(vocab_size=cfg.vocab_size, **REST_PREFIX)
    geom = dict(slots=8, page_size=16, dtype=torch.bfloat16, device=dev,
                max_len=_rest_max_len(generate(spec)),
                prefill_chunk=REST_CHUNK)
    runs = {}
    for name, on in (("on", True), ("off", False)):
        reqs = generate(spec)
        eng = ServingEngine(cfg, params, prefix_cache=on, **geom)
        rep, counts = _rest_serve(eng, reqs)
        _add_counts(total, counts)
        if on:
            eng._prefix.drop_all()
        leaked = eng.cache.release_all()
        clean = (leaked == 0 and eng.cache.live_pages == 0
                 and eng.cache.refcounts_balanced())
        del eng
        free_device()
        runs[name] = (rep, reqs)
        log({"phase": "rest_prefix", "run": name, "card": card,
             "max_len": geom["max_len"], **rep, "released_clean": clean,
             "launches": counts})
        fails += _rest_launch_fails(f"(c) {name}", rep, counts,
                                    cfg.num_layers)
        if rep["completed"] != len(reqs) or not clean:
            fails.append(f"(c) {name}: completed {rep['completed']}, "
                         f"clean {clean}")
    (on, on_reqs), (off, off_reqs) = runs["on"], runs["off"]
    log({"phase": "rest_prefix_summary", "card": card,
         "prefix_hit_rate": on["prefix_hit_rate"],
         "prefill_tokens_cached": on["prefill_tokens_cached"],
         "prefill_flops_avoided": on["prefill_flops_avoided"],
         "tail_prefills": on["prefix_hits"],
         "ttft_p50_s": [on["ttft_p50_s"], off["ttft_p50_s"]],
         "ttft_p99_s": [on["ttft_p99_s"], off["ttft_p99_s"]],
         "stream_agreement": _agreement(on_reqs, _streams(off_reqs))})
    if not (on["prefix_hits"] > 0 and on["prefill_flops_avoided"] > 0):
        fails.append(f"(c) no prefix hit: {on['prefix_hits']} hits")


def rest_fleet(cfg, params, dev, card: str, fails: list,
               total: dict) -> None:
    """(d): one prefill and one decode worker on the card over a loopback
    KV plane against a colocated engine, on the f32 and the fp8 wire;
    the fp8 wire's pages bitwise ``demote_page`` of the same pages."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.run.http_kv import KVClient, RendezvousServer
    from horovod_tpu_torch.run.secret import make_secret_key
    from horovod_tpu_torch.serving import (CacheConfig, DecodeWorker,
                                           LoadSpec, PagedKVCache,
                                           PrefillWorker, ServingEngine,
                                           ServingFleet, decode_kv,
                                           encode_kv, generate,
                                           import_pages, prefill_forward)
    bf16, layers = torch.bfloat16, cfg.num_layers
    spec = LoadSpec(vocab_size=cfg.vocab_size, **REST_FLEET)
    geom = dict(slots=8, page_size=16, dtype=bf16, device=dev,
                max_len=_rest_max_len(generate(spec)))
    colo_reqs = generate(spec)
    eng = ServingEngine(cfg, params, **geom)
    colo, counts = _rest_serve(eng, colo_reqs)
    _add_counts(total, counts)
    del eng
    free_device()
    colo_streams = _streams(colo_reqs)
    secret = make_secret_key()
    srv = RendezvousServer(secret, host="127.0.0.1")
    try:
        kv = KVClient("127.0.0.1", srv.port, secret)
        wire = {}
        for tier in ("f32", "fp8"):
            dec = ServingEngine(cfg, params, kv_compress=(tier == "fp8"),
                                **geom)
            _warm(dec)
            fleet = ServingFleet(
                [PrefillWorker("p0", cfg, params, kv, page_size=16,
                               dtype=bf16, tier=tier, device=dev)],
                [DecodeWorker("decode0", dec, kv)], kv)
            reqs = generate(spec)
            registry.reset_launch_counts()
            frep = fleet.serve(reqs).as_dict()
            counts = registry.launch_counts()
            _add_counts(total, counts)
            del fleet, dec
            free_device()
            same = _streams(reqs) == colo_streams
            wire[tier] = frep["kv_bytes_out"]
            log({"phase": "rest_fleet", "tier": tier, "card": card,
                 **frep, "streams_bitwise_colocated": same,
                 "stream_agreement": _agreement(reqs, colo_streams),
                 "colocated_tokens_per_s": colo["tokens_per_s"],
                 "colocated_ttft_p50_s": colo["ttft_p50_s"],
                 "launches": counts})
            decode = "flash_decode_fp8" if tier == "fp8" else "flash_decode"
            rep = {"prefill_forwards": frep["handoffs_streamed"]
                   + frep["handoffs_local"],
                   "decode_steps": frep["decode_steps"]}
            fails += _rest_launch_fails(f"(d) {tier}", rep, counts, layers,
                                        decode=decode)
            if not (frep["completed"] == len(reqs)
                    and frep["handoffs_streamed"] == len(reqs)
                    and frep["kv_bytes_in"] == frep["kv_bytes_out"] > 0
                    and not any(frep["leaked_pages"].values())
                    and frep["refcounts_balanced"]):
                fails.append(f"(d) {tier}: {frep}")
            if tier == "f32" and not same:
                fails.append("(d) the f32 fleet's streams are not bitwise "
                             "the colocated engine's")
    finally:
        srv.stop()
    # The fp8 wire against demote_page of the same resident pages.
    r = max(colo_reqs, key=lambda q: q.prompt_len)
    _, kl, vl = prefill_forward(params, cfg,
                                torch.tensor(r.prompt, device=dev)[None],
                                dtype=bf16)
    ccfg = CacheConfig(num_layers=layers, num_kv_heads=cfg.num_kv_heads,
                       head_dim=cfg.head_dim, slots=1, page_size=16,
                       max_len=geom["max_len"], dtype="bfloat16",
                       compress=True)
    local, remote = PagedKVCache(ccfg, dev), PagedKVCache(ccfg, dev)
    local.write_prefill(0, kl[:, 0], vl[:, 0])
    full = r.prompt_len // 16
    cpids = [local.demote_page(int(local.page_table[0, i]))
             for i in range(full)]
    import_pages(remote, 0, decode_kv(encode_kv(kl[:, 0], vl[:, 0],
                                                page_size=16, tier="fp8")))
    rc = [int(remote.cpage_table[0, i]) for i in range(full)]
    same = all(torch.equal(getattr(local, n)[:, cpids].view(torch.uint8),
                           getattr(remote, n)[:, rc].view(torch.uint8))
               for n in ("kq", "vq", "kscale", "vscale"))
    log({"phase": "rest_fleet_fp8_pages", "card": card,
         "prompt_len": r.prompt_len, "pages": full,
         "bitwise_demote_page": same, "wire_bytes": wire,
         "fp8_over_f32": wire["fp8"] / wire["f32"]})
    if not same:
        fails.append("(d) fp8 wire pages are not bitwise demote_page's")
    del local, remote, kl, vl


def serving_rest(dev, card: str, serve_run: dict) -> dict:
    """Phase 27 (module docstring).  Returns the kernels' launches over
    its serve and fleet runs."""
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    cfg = LLAMA3_8B
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=torch.bfloat16,
                               device=dev)
    fails: list = []
    total: dict = {}
    for part in (lambda: rest_chunked(cfg, params, dev, card, fails, total),
                 lambda: rest_fp8(cfg, params, dev, card, serve_run, fails,
                                  total),
                 lambda: rest_prefix(cfg, params, dev, card, fails, total),
                 lambda: rest_fleet(cfg, params, dev, card, fails, total)):
        t0 = time.perf_counter()
        part()
        free_device()
        log({"phase": "rest_part_seconds",
             "seconds": time.perf_counter() - t0})
    del params
    if fails:
        raise AssertionError("serving_rest: " + "; ".join(fails))
    return total


# ---------------------------------------------------------------------------
# Phase 28: the 3-D step -- BERT-Large DP x TP, sequence parallelism and a
# sub-mesh sync BN
# ---------------------------------------------------------------------------


PAR_TP = 2                     # (b): tensor-parallel ranks on the one card
PAR_STEPS = 5                  # (a): timed steps
PAR_BATCH = (64, 128)          # phase 12's cell
PAR_DTYPE = torch.bfloat16     # compute dtype of (a) and (b)
PAR_LONG = ["--sp", "1", "--seq-len", "4096", "--steps", "5",
            "--d-model", "256", "--heads", "4",
            "--compare-single-device"]           # (c): head dim 64
PAR_SP_SHAPE = (2, 4, 4096, 64)   # (c): PAR_LONG's q/k/v (b, h, t, d)
PAR_WORKER_TIMEOUT = 240
PAR_WORKER_DEVICE = "cuda:0"   # (b): both ranks on the one card
PAR_F32_GRAD_TOL = 1e-3        # f32 gradients: roundoff through 24 layers,
                               # relative to max |reference grad|
PAR_BF16_FLOOR_FACTOR = 2.0    # bf16: twice Bert's own rounding distance
                               # (tp rounds each partial sum as well)


def _bert_tp_model(cfg, dev, params, specs, mesh, tp: int):
    from horovod_tpu_torch.models import BertTP
    from horovod_tpu_torch.parallel import shard_params
    local = shard_params({k: v.clone() for k, v in params.items()}, specs,
                         mesh.axis_index("model"), tp)
    return BertTP(cfg, local, PAR_DTYPE, axis="model")


def _bert_tp_step(model, specs, mesh, tp: int, **kw):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import data_axes
    from horovod_tpu_torch.training import (bert_pretrain_loss,
                                            make_train_step)
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3, weight_decay=1e-4),
        named_parameters=named, compression=hvd.Compression.none,
        process_set=mesh.group(data_axes(mesh)))
    return make_train_step(model, bert_pretrain_loss, opt, tp=tp,
                           param_specs=specs, **kw)


def _grad_errs(got: dict, want: dict) -> dict:
    """``{leaf: max |got - want| / max |want|}`` (``wk.bias``, zero in
    exact arithmetic, over its layer's ``wk.kernel``'s max)."""
    def scale(n):
        if n.endswith(".wk.bias"):
            n = n[:-len("bias")] + "kernel"
        return max(want[n].abs().max().item(), 1e-30)
    return {n: (got[n].to(want[n].device).float() - want[n]).abs().max()
            .item() / scale(n) for n in want}


def _grad_gate(errs32: dict, errs16: dict, floor: dict,
               direct16: dict) -> dict:
    """The gradient gate of a deep bf16 backward (phase 7's reasoning: at
    24 layers bf16 rounding alone moves gradients past phase 11's 2e-2).
    In f32 every gradient within ``PAR_F32_GRAD_TOL`` of the reference's
    (``errs32``: roundoff).  In bf16 each gradient's distance from the
    f32 reference (``errs16``) within ``BF16_TOL`` of its max, or within
    ``PAR_BF16_FLOOR_FACTOR`` times the port's ``Bert``'s own bf16
    distance from f32 (``floor``) where that is larger.  ``direct16``
    (the bf16 gradients against the other bf16 path's) is logged beside.
    Returns the record; ``ok`` says whether it held."""
    worst32 = max((v, n) for n, v in errs32.items())
    worst16 = max((v, n) for n, v in errs16.items())
    direct = max((v, n) for n, v in direct16.items())
    gate = {n: max(BF16_TOL, PAR_BF16_FLOOR_FACTOR * floor[n])
            for n in errs16}
    margin = min((gate[n] / max(v, 1e-30), n) for n, v in errs16.items())
    return {"worst_grad_rel_err_f32": worst32[0], "worst_grad_f32":
            worst32[1], "f32_tol": PAR_F32_GRAD_TOL,
            "worst_grad_rel_err_bf16_vs_f32": worst16[0],
            "worst_grad_bf16_vs_f32": worst16[1],
            "worst_grad_rel_err_bf16_vs_bf16": direct[0],
            "worst_grad_bf16_vs_bf16": direct[1], "bf16_tol": BF16_TOL,
            "bert_bf16_vs_f32_max": max(floor.values()),
            "bert_leaves_above_bf16_tol": sum(v > BF16_TOL
                                              for v in floor.values()),
            "bf16_margin": margin[0], "bf16_margin_leaf": margin[1],
            "leaves_over_gate": sum(v > gate[n] for n, v in errs16.items()),
            "ok": worst32[0] <= PAR_F32_GRAD_TOL and margin[0] >= 1.0}


def _drop_shard(grads: dict, specs: dict) -> dict:
    """``grads`` with the last of ``PAR_TP`` blocks of every split leaf
    zeroed: the gather of (b) with one rank's shard lost."""
    from horovod_tpu_torch.parallel.tp import split_dim
    out = {}
    for n, g in grads.items():
        d = split_dim(specs.get(n, ()))
        if d is not None:
            w = g.shape[d] // PAR_TP
            g = g.clone()
            g.narrow(d, g.shape[d] - w, w).zero_()
        out[n] = g
    return out


def tp_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 28 (b): gloo opened here (NCCL refuses two ranks
    on one GPU), then ``hvd.init(device="cuda:0")``, which keeps it."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BERT_LARGE, init_bert_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.parallel import (build_3d_mesh, gather_tp_params,
                                            tp_param_specs)
    from horovod_tpu_torch.parallel.tp import split_bytes
    from horovod_tpu_torch.timeline.metrics import collective_totals
    from horovod_tpu_torch.training import bert_pretrain_loss
    hvd.init(device=PAR_WORKER_DEVICE)
    dev = torch.device(PAR_WORKER_DEVICE)
    cfg = BERT_LARGE
    mesh = build_3d_mesh(data=1, model=world)
    params = init_bert_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    specs = tp_param_specs(params, axis="model")
    full_split = split_bytes(params, specs)
    model = _bert_tp_model(cfg, dev, params, specs, mesh, world)
    del params
    local = dict(model.named_parameters())
    batch = bert_batch(cfg, dev, *PAR_BATCH, seed=0)
    losses, counts = {}, {}
    for dtype, suffix in ((torch.float32, ".grads32"), (PAR_DTYPE, ".grads")):
        model.dtype = dtype
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        loss = bert_pretrain_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        counts[str(dtype)] = registry.launch_counts()
        losses[str(dtype)] = loss.item()
        grads = gather_tp_params({n: p.grad for n, p in local.items()},
                                 specs, axis="model")
        if rank == 0:
            torch.save({n: g.detach().cpu() for n, g in grads.items()},
                       out + suffix)
        del grads, loss
        model.zero_grad(set_to_none=True)
    # The negative control: Megatron's "f" as an identity, so the
    # backward leaves each rank's partial gradient above every
    # column-parallel layer (bert_tp_apply imports it at each call).
    from horovod_tpu_torch.parallel import tp as tp_mod
    copy_to_tp = tp_mod.copy_to_tp
    tp_mod.copy_to_tp = lambda x, **_: x
    try:
        bert_pretrain_loss(model, batch).backward()
    finally:
        tp_mod.copy_to_tp = copy_to_tp
    grads = gather_tp_params({n: p.grad for n, p in local.items()},
                             specs, axis="model")
    if rank == 0:
        torch.save({n: g.detach().cpu() for n, g in grads.items()},
                   out + ".grads_fault")
    del grads
    model.zero_grad(set_to_none=True)
    step = _bert_tp_step(model, specs, mesh, world)
    model_set = mesh.group("model").name
    before = collective_totals().get(("allreduce", model_set),
                                     {"calls": 0})["calls"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_loss = step(batch).item()
    step_ms = 1e3 * (time.perf_counter() - t0)
    after = collective_totals()[("allreduce", model_set)]["calls"]
    torch.save({"loss": losses[str(PAR_DTYPE)],
                "loss_f32": losses["torch.float32"], "step_loss": step_loss,
                "step_ms": step_ms, "launches": counts[str(PAR_DTYPE)],
                "launches_f32": counts["torch.float32"],
                "tp_allreduces": after - before,
                "split_bytes": split_bytes(local, specs),
                "full_split_bytes": full_split,
                "backend": dist.get_backend(),
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}, out)
    hvd.shutdown()
    dist.destroy_process_group()
    return 0


def _par_tp_world(here: str, tmp: str, job: str = "parallel_3d",
                  world: int = PAR_TP,
                  timeout: float = PAR_WORKER_TIMEOUT,
                  env: dict = None) -> list:
    """``world`` worker processes of ``TP_JOBS[job]`` (``--tp-worker
    <job>``): phase 28 (b), 29 or 30, ``env`` added to their environment.
    Returns each rank's record."""
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=here, **(env or {}))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--tp-worker",
         job, str(r), str(world), store, os.path.join(tmp, f"r{r}.pt")],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{job}: rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
            for r in range(world)]


def _par_sp_attention(dev) -> tuple:
    """Phase 28 (c): ``ulysses_attention`` (the flash kernels) and
    ``ring_attention`` (plain PyTorch) over the current mesh's ``sp`` set
    against ``attention_reference`` on the same f32 q/k/v and output
    gradient at ``PAR_SP_SHAPE``, causal, without and with two packed
    segments: outputs within ``F32_TOL`` and dq/dk/dv within
    ``F32_GRAD_TOL``, each of the reference's max |value|.  Returns
    ``(record, failures)``; its launches are a comparison's and count
    for nothing."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.ops.attention import attention_reference
    from horovod_tpu_torch.parallel import ring_attention, ulysses_attention
    b, h, t, d = PAR_SP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(28)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   for _ in range(4))
    seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
    seg[:, t // 2:] = 1
    rec, fails = {}, []
    for case, s in (("causal", None), ("causal_packed", seg)):
        fns = (("reference", lambda *a: attention_reference(
                   *a, causal=True, segment_ids=s)),
               ("ulysses", lambda *a: ulysses_attention(
                   *a, causal=True, axis="sp", segment_ids=s)),
               ("ring", lambda *a: ring_attention(
                   *a, causal=True, axis="sp", segment_ids=s)))
        res = {}
        for name, fn in fns:
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            registry.reset_launch_counts()
            o = fn(*xs)
            res[name] = (o.detach(), *torch.autograd.grad(o, xs, do))
            torch.cuda.synchronize()
            if name == "ulysses":
                launches = {f: registry.launch_counts()[f] for f in
                            ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
            del xs, o
        want = res.pop("reference")
        tols = [(F32_TOL if j == 0 else F32_GRAD_TOL)
                * w.abs().max().item() for j, w in enumerate(want)]
        rec[case] = {"ulysses_launches": launches}
        for name, got in res.items():
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            rec[case][name] = dict(zip(("out", "dq", "dk", "dv"), errs))
            if not all(e <= tol for e, tol in zip(errs, tols)):
                fails.append(f"(c) {name} {case} vs attention_reference: "
                             f"{errs} over {tols}")
        rec[case]["tols"] = tols
        if launches != {f: 1 for f in launches}:
            fails.append(f"(c) ulysses {case} launches {launches}")
        del res, want
    return rec, fails


def parallel_3d(dev, card: str, bert_step_ms) -> dict:
    """Phase 28 (module docstring): (a) BERT-Large through the 3-D step
    at world 1 on NCCL, against the port's ``Bert``; (b) tp = 2 as two
    gloo ranks on the one card, against (a); (c) ``long_context`` at sp 1
    (Ulysses and ring) and ``sync_batch_norm(axes=("data",))`` against
    phase 13's layer.  Returns the kernels' launches of the phase."""
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import long_context
    from horovod_tpu_torch.models import BERT_LARGE, Bert, init_bert_params
    from horovod_tpu_torch.ops import bn, registry
    from horovod_tpu_torch.parallel import build_3d_mesh, tp_param_specs
    from horovod_tpu_torch.parallel.tp import split_bytes
    from horovod_tpu_torch.training import (bert_pretrain_loss,
                                            mlm_nsp_loss, sync_batch_norm)

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    fails, total = [], {}
    cfg, (b, t) = BERT_LARGE, PAR_BATCH
    # (a) world 1 on NCCL.
    torch.cuda.reset_peak_memory_stats()
    hvd.init()
    mesh = build_3d_mesh(data=1, model=1)
    params = init_bert_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    specs = tp_param_specs(params, axis="model")
    batch = bert_batch(cfg, dev, b, t, seed=0)
    g_ref, loss_ref = {}, {}
    for dtype in (torch.float32, PAR_DTYPE):
        ref = Bert.from_params(cfg, {k: v.clone() for k, v in
                                     params.items()}, dtype=dtype)
        loss = mlm_nsp_loss(*ref(batch[0]), *batch)
        loss.backward()
        g_ref[dtype] = {n: p.grad.float() for n, p in ref.named_parameters()}
        loss_ref[dtype] = loss.item()
        del ref, loss
    # bf16's own distance from f32 in the port's Bert: the noise floor.
    floor = _grad_errs(g_ref[PAR_DTYPE], g_ref[torch.float32])
    model = _bert_tp_model(cfg, dev, params, specs, mesh, 1)
    split_a = split_bytes(params, specs)
    del params
    g_a, loss_a = {}, {}
    for dtype in (torch.float32, PAR_DTYPE):
        model.dtype = dtype
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        loss = bert_pretrain_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        grad_counts = registry.launch_counts()
        g_a[dtype] = {n: p.grad.float().clone()
                      for n, p in model.named_parameters()}
        loss_a[dtype] = loss.item()
        model.zero_grad(set_to_none=True)
        del loss
    gate_a = _grad_gate(_grad_errs(g_a[torch.float32],
                                   g_ref[torch.float32]),
                        _grad_errs(g_a[PAR_DTYPE], g_ref[torch.float32]),
                        floor, _grad_errs(g_a[PAR_DTYPE], g_ref[PAR_DTYPE]))
    loss_rel = abs(loss_a[PAR_DTYPE] - loss_ref[PAR_DTYPE]) \
        / abs(loss_ref[PAR_DTYPE])
    loss_rel32 = abs(loss_a[torch.float32] - loss_ref[torch.float32]) \
        / abs(loss_ref[torch.float32])
    del g_ref
    step = _bert_tp_step(model, specs, mesh, 1)
    losses = [step(batch).item()]                       # warm-up
    registry.reset_launch_counts()
    times = []
    for _ in range(PAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t0)
    counts_a = registry.launch_counts()
    _add_counts(total, counts_a)
    step_ms = 1e3 * sum(times) / PAR_STEPS
    peak_a = torch.cuda.max_memory_allocated()
    del model, step
    backend_a = torch.distributed.get_backend()
    hvd.shutdown()
    free_device()
    rec_a = {"world": 1, "backend": backend_a, "mesh": dict(mesh.shape),
             "batch": [b, t], "dtype": str(PAR_DTYPE),
             "loss": loss_a[PAR_DTYPE], "loss_bert": loss_ref[PAR_DTYPE],
             "loss_rel_err": loss_rel, "loss_f32": loss_a[torch.float32],
             "loss_rel_err_f32": loss_rel32, "grads": gate_a,
             "grad_launches": grad_counts, "losses": losses,
             "step_ms": step_ms, "step_ms_each": [1e3 * x for x in times],
             "phase12_step_ms": bert_step_ms, "launches": counts_a,
             "peak_mem_bytes": peak_a, "split_bytes": split_a}
    if loss_rel > 1e-2 or loss_rel32 > PAR_F32_GRAD_TOL or \
            not gate_a["ok"]:
        fails.append(f"(a) vs Bert: loss {loss_rel} ({loss_rel32} in "
                     f"f32), grads {gate_a}")
    if not all(np.isfinite(losses)):
        fails.append(f"(a) losses {losses}")
    for f in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        if grad_counts[f] != cfg.num_layers or \
                counts_a[f] != cfg.num_layers * PAR_STEPS:
            fails.append(f"(a) {f} launches {grad_counts[f]}, "
                         f"{counts_a[f]}")
    # (b) tp = 2 on the one card, two gloo ranks.
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _par_tp_world(here, tmp)
        def grads(suffix):
            return torch.load(os.path.join(tmp, "r0.pt" + suffix),
                              weights_only=False, mmap=True)

        def gate(g, errs32):
            return _grad_gate(errs32, _grad_errs(g, g_a[torch.float32]),
                              floor, _grad_errs(g, g_a[PAR_DTYPE]))

        errs32 = _grad_errs(grads(".grads32"), g_a[torch.float32])
        g_b = grads(".grads")
        gate_b = gate(g_b, errs32)
        # The two faults, each under the same gate: it must reject both.
        faults = {"no_copy_to_tp": gate(grads(".grads_fault"), errs32),
                  "dropped_shard": gate(_drop_shard(g_b, specs), errs32)}
        del g_b
    del g_a
    free_device()
    loss_rel_b = abs(ranks[0]["loss"] - loss_a[PAR_DTYPE]) \
        / abs(loss_a[PAR_DTYPE])
    loss_rel_b32 = abs(ranks[0]["loss_f32"] - loss_a[torch.float32]) \
        / abs(loss_a[torch.float32])
    rec_b = {"world": PAR_TP, "mesh": {"data": 1, "model": PAR_TP},
             "backend": [r["backend"] for r in ranks],
             "loss": [r["loss"] for r in ranks],
             "loss_a": loss_a[PAR_DTYPE], "loss_rel_err": loss_rel_b,
             "loss_f32": [r["loss_f32"] for r in ranks],
             "loss_rel_err_f32": loss_rel_b32, "grads": gate_b,
             "faults": faults,
             "step_loss": [r["step_loss"] for r in ranks],
             "step_ms": [r["step_ms"] for r in ranks],
             "launches": [r["launches"] for r in ranks],
             "launches_f32": [r["launches_f32"] for r in ranks],
             "tp_allreduces_a_step": [r["tp_allreduces"] for r in ranks],
             "split_bytes": [r["split_bytes"] for r in ranks],
             "split_bytes_a": split_a,
             "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks]}
    for r in ranks:
        _add_counts(total, r["launches"])
        _add_counts(total, r["launches_f32"])
    if loss_rel_b > 1e-2 or loss_rel_b32 > PAR_F32_GRAD_TOL or \
            not gate_b["ok"]:
        fails.append(f"(b) vs (a): loss {loss_rel_b} ({loss_rel_b32} in "
                     f"f32), grads {gate_b}")
    for name, rec in faults.items():
        if rec["bf16_margin"] >= 1.0:
            fails.append(f"(b) the bf16 gate passes the fault {name}: {rec}")
    for r, res in enumerate(ranks):
        if any(res["launches"][f] != cfg.num_layers for f in
               ("flash", "flash_bwd_dq", "flash_bwd_dkv")):
            fails.append(f"(b) rank {r} launches {res['launches']}")
        if 2 * res["split_bytes"] != split_a or \
                res["full_split_bytes"] != split_a:
            fails.append(f"(b) rank {r} holds {res['split_bytes']} of "
                         f"{split_a} split bytes")
        if res["tp_allreduces"] != 4 * cfg.num_layers:
            fails.append(f"(b) rank {r}: {res['tp_allreduces']} tp "
                         f"allreduces a step")
        if res["backend"] != "gloo" or not np.isfinite(res["step_loss"]):
            fails.append(f"(b) rank {r}: {res['backend']}, "
                         f"{res['step_loss']}")
    # (c) long context at sp 1, then the sub-mesh sync BN.
    hvd.init()
    runs = {}
    for mode in ("ulysses", "ring"):
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = long_context.main(PAR_LONG + ["--mode", mode])
        torch.cuda.synchronize()
        runs[mode] = {"losses": run["losses"], "ref_loss": run["ref_loss"],
                      "seconds": time.perf_counter() - t0,
                      "launches": registry.launch_counts()}
        _add_counts(total, runs[mode]["launches"])
        free_device()
    first = {m: r["losses"][0] for m, r in runs.items()}
    for mode, r in runs.items():
        ls = r["losses"]
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            fails.append(f"(c) {mode} losses {ls}")
    if abs(first["ulysses"] - first["ring"]) > 2e-2:
        fails.append(f"(c) first losses {first}")
    want = {f: 5 for f in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
    if {f: runs["ulysses"]["launches"][f] for f in want} != want or \
            any(runs["ring"]["launches"].values()):
        fails.append(f"(c) launches {runs}")
    sp_attention, sp_fails = _par_sp_attention(dev)
    fails += sp_fails
    free_device()
    build_3d_mesh(data=1)
    shape = BN_SYNC_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    c = shape[-1]
    x = (2.0 * torch.randn(*shape, generator=gen, device=dev)
         + 0.5).to(torch.bfloat16)
    dy = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    state = {"scale": 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev),
             "bias": 0.1 * torch.randn(c, generator=gen, device=dev),
             "mean": torch.zeros(c, device=dev),
             "var": torch.ones(c, device=dev)}
    bn_runs = {}
    for name, m in (("sub_mesh", sync_batch_norm(
            axes=("data",), features=c, momentum=0.9,
            dtype=torch.bfloat16, device=dev)),
                    ("plain", bn.BatchNorm(c, momentum=0.9,
                                           dtype=torch.bfloat16,
                                           device=dev))):
        m.load_state_dict(state)
        registry.reset_launch_counts()
        out = _bn_step(m, x, dy)
        torch.cuda.synchronize()
        bn_runs[name] = (out + (m.mean.clone(), m.var.clone()),
                         registry.launch_counts())
    _add_counts(total, bn_runs["sub_mesh"][1])
    bn_bitwise = all(torch.equal(p, q) for p, q in
                     zip(bn_runs["sub_mesh"][0], bn_runs["plain"][0]))
    bn_launches = {k: bn_runs["sub_mesh"][1][k]
                   for k in ("bn_bwd_reduce", "bn_bwd_dx")}
    if not bn_bitwise:
        fails.append("(c) sync_batch_norm(axes=('data',)) differs from "
                     "the plain layer")
    if bn_launches != {"bn_bwd_reduce": 1, "bn_bwd_dx": 1}:
        fails.append(f"(c) BN launches {bn_launches}")
    del x, dy, bn_runs
    hvd.shutdown()
    free_device()
    seconds = time.perf_counter() - t_phase
    log({"phase": "parallel_3d", "card": card, "a": rec_a, "b": rec_b,
         "c": {"long_context": runs, "first_losses": first,
               "sp_attention_vs_reference": sp_attention,
               "sync_bn_shape": list(shape),
               "sync_bn_bitwise_phase13_layer": bn_bitwise,
               "sync_bn_launches": bn_launches},
         "launches": total, "seconds": seconds, "ok": not fails})
    if fails:
        raise AssertionError("parallel_3d: " + "; ".join(fails))
    return total


# ---------------------------------------------------------------------------
# Phase 29: tensor-parallel serving -- Llama-3 8B at tp 2, the engine's
# mesh and the control plane
# ---------------------------------------------------------------------------


SERVE_TP = 2                   # ranks on the one card (gloo, as phase 28 (b))
SERVE_TP_STEPS = 8             # (a): teacher-forced steps
SERVE_TP_FAULT_LAYER = 16      # (a): the layer whose w_down sum the fault skips
SERVE_TP_F32_LAYERS = 2        # (a): the f32 repeat's depth (full width)
SERVE_TP_TIMEOUT = 300


class _ScriptedPolicy:
    """``script``: decide-call index -> Decision; every other call holds."""

    def __init__(self, script):
        self.script = dict(script)
        self.calls = 0

    def decide(self, sample):
        from horovod_tpu_torch.serving import Decision
        d = self.script.pop(self.calls, None)
        self.calls += 1
        return d if d is not None else Decision("hold", "scripted")

    def mark_applied(self, decision, now_s):
        pass


def _skip_sum(decode_mod, layer: int):
    """A ``row_parallel`` that returns its rank's partial, without the
    sum, at ``layer``'s ``w_down`` product (the step's ``2 * layer + 1``-th
    call) and sums the others: the fault (a) scores."""
    real = decode_mod.row_parallel
    calls = [0]

    def fake(x, kernel, bias=None, *, axis=None, mesh=None):
        i = calls[0]
        calls[0] += 1
        if i == 2 * layer + 1:
            return x @ kernel
        return real(x, kernel, bias, axis=axis, mesh=mesh)
    return fake


def _tp_steps(cfg, params, dtype, mesh, dev, rank: int, steps: int,
              fault_layer=None, compress: bool = False) -> dict:
    """Phase 29 (a) on one rank: phase 4's prompts prefilled (on the full
    params) into this rank's tp pool and, on rank 0, a tp 1 pool; then
    ``steps`` teacher-forced steps of the tp step on this rank's shard
    and, on rank 0, of the tp 1 step on the full params, fed the same
    tokens.  Per step: rank 0's logit distance from tp 1 over tp 1's max
    |logit|, greedy agreement, and this rank's decode launches.  Then
    (``fault_layer``) one more step with that layer's ``w_down`` sum
    skipped on every rank, scored the same way, and (``compress``) half
    of each slot's cold pages compressed in both pools -- their e4m3
    shards and scales against rank 0's tp 1 pool's heads -- and one
    compressed tp step against the plain tp step over this rank's pool
    holding the dequantised rows (bitwise, as phase 27 (b) at tp 1)."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.parallel import shard_params
    from horovod_tpu_torch.serving import (CacheConfig, LoadSpec,
                                           PagedKVCache, build_decode_step,
                                           cache_sharding,
                                           decode_param_specs, generate,
                                           prefill_forward)
    from horovod_tpu_torch.serving import decode as decode_mod
    from horovod_tpu_torch.serving.kvcache import dtype_name
    local = shard_params(params, decode_param_specs(params),
                         mesh.axis_index("tp"), mesh.size)
    ccfg = CacheConfig(num_layers=cfg.num_layers,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       dtype=dtype_name(dtype), compress=compress,
                       **SERVE_GEOM)
    kw = dict(slots=ccfg.slots, page_size=ccfg.page_size,
              pages_per_slot=ccfg.pages_per_slot, dtype=dtype)
    run = {"tp": (PagedKVCache(ccfg, cache_sharding(mesh, device=dev)),
                  build_decode_step(cfg, mesh, **kw), local)}
    if rank == 0:
        run["one"] = (PagedKVCache(ccfg, dev), build_decode_step(cfg, **kw),
                      params)
    reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
    for slot, r in enumerate(reqs):
        _, kl, vl = prefill_forward(params, cfg, torch.tensor(
            r.prompt, dtype=torch.long, device=dev)[None], dtype=dtype)
        for cache, *_ in run.values():
            cache.write_prefill(slot, kl[:, 0], vl[:, 0])
        del kl, vl
    slots = ccfg.slots
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    toks = np.random.RandomState(29).randint(
        0, cfg.vocab_size, (steps + 1, slots))

    def one_step(j):
        out = {}
        for name, (cache, step, p) in run.items():
            for s in range(slots):
                cache.reserve(s, int(cache.lengths[s]) + 1)
            torch.cuda.synchronize()
            registry.reset_launch_counts()
            logits, cache.k, cache.v = step(
                p, cache.k, cache.v,
                torch.tensor(toks[j], dtype=torch.long, device=dev),
                cache.lengths_device().long(), cache.table_device(),
                active)
            torch.cuda.synchronize()
            out[name] = (logits.float(), registry.launch_counts())
            for s in range(slots):
                cache.lengths[s] += 1
        rec = {"launches": out["tp"][1]}
        if rank == 0:
            got, want = out["tp"][0], out["one"][0]
            rec.update(
                rel_err=(got - want).abs().max().item()
                / max(want.abs().max().item(), 1e-30),
                greedy_equal=bool(torch.equal(got.argmax(-1),
                                              want.argmax(-1))),
                finite=bool(torch.isfinite(got).all()))
        return rec

    res = {"steps": [one_step(j) for j in range(steps)]}
    if fault_layer is not None:
        real = decode_mod.row_parallel
        decode_mod.row_parallel = _skip_sum(decode_mod, fault_layer)
        try:
            res["fault"] = one_step(steps)
        finally:
            decode_mod.row_parallel = real
    if compress:
        cache_tp, cache_one = run["tp"][0], run.get("one", (None,))[0]
        # Room for the step's write first: the pages compress_cold frees
        # then stay free, and the plain pool below holds their rows.
        for cache, *_ in run.values():
            for s in range(slots):
                n = int(cache.lengths[s])
                cache.reserve(s, n + 1, writable_from=n)
        old = cache_tp.page_table.copy()
        n = 0
        for s in range(slots):
            half = len(cache_tp._cold_indices(s)) // 2
            got = cache_tp.compress_cold(s, max_pages=half)
            if cache_one is not None:
                assert cache_one.compress_cold(s, max_pages=half) == got
            n += got
        cp = torch.tensor(cache_tp.cpage_table[cache_tp.comp_mask],
                          dtype=torch.long, device=dev)
        shards = [cache_tp.kq[:, cp].view(torch.uint8).contiguous(),
                  cache_tp.vq[:, cp].view(torch.uint8).contiguous()]
        equal = True
        for r in range(mesh.size):
            for i, name in enumerate(("kq", "vq")):
                t = shards[i].clone() if rank == r else \
                    torch.empty_like(shards[i])
                dist.broadcast(t, src=r)
                if rank == 0:
                    h0 = r * cache_tp.local_heads
                    want = getattr(cache_one, name)[:, cp][
                        ..., h0:h0 + cache_tp.local_heads, :]
                    equal = equal and torch.equal(
                        t, want.contiguous().view(torch.uint8))
        if rank == 0:
            equal = equal and all(torch.equal(
                getattr(cache_tp, sc)[:, cp], getattr(cache_one, sc)[:, cp])
                for sc in ("kscale", "vscale"))
            equal = equal and np.array_equal(cache_tp.cpage_table,
                                              cache_one.cpage_table)
        res["compressed_pages"] = n
        res["e4m3_shards_equal"] = equal
        cm = cache_tp.comp_mask.copy()
        plain_table = cache_tp.page_table.copy()
        plain_table[cm] = old[cm]
        pids = torch.tensor(old[cm], dtype=torch.long, device=dev)
        cps = torch.tensor(cache_tp.cpage_table[cm], dtype=torch.long,
                           device=dev)
        deq_k, deq_v = cache_tp.k.clone(), cache_tp.v.clone()
        deq_k[:, pids] = cache_tp.dequantized("k", cps)
        deq_v[:, pids] = cache_tp.dequantized("v", cps)
        args = (torch.tensor(toks[steps], dtype=torch.long, device=dev),
                cache_tp.lengths_device().long())
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        got, _, _ = build_decode_step(cfg, mesh, compress=True, **kw)(
            local, cache_tp.k, cache_tp.v, *args, cache_tp.table_device(),
            active, *cache_tp.compress_operands())
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        want, _, _ = run["tp"][1](local, deq_k, deq_v, *args, torch.tensor(
            plain_table, dtype=torch.int32, device=dev), active)
        res["compressed_step"] = {
            "launches": counts,
            "bitwise_plain_step_on_dequantised_pool": bool(
                torch.equal(got, want)),
            "finite": bool(torch.isfinite(got).all())}
        del deq_k, deq_v, got, want
    del run, local
    return res


def serving_tp_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 29: gloo opened here (NCCL refuses two ranks on
    one GPU), then ``hvd.init(device="cuda:0")``; Llama-3 8B's bf16
    weights from seed 0 on the card, the same tree on each rank."""
    import dataclasses as dc

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.autoscale_probe import check_ctl_metrics
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.parallel import build_parallel_mesh
    from horovod_tpu_torch.serving import (Decision, LoadSpec, PolicyConfig,
                                           Request, ServingControlPlane,
                                           ServingEngine, generate)
    from horovod_tpu_torch.timeline.metrics import (collective_totals,
                                                    render_prometheus)
    hvd.init(device=PAR_WORKER_DEVICE)
    dev = torch.device(PAR_WORKER_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = build_parallel_mesh(tp=world)
    res = {"backend": dist.get_backend()}

    # (a') f32 at 2 layers, full width: greedy tokens equal tp 1's.
    cfg2 = dc.replace(LLAMA3_8B, num_layers=SERVE_TP_F32_LAYERS)
    params = init_llama_params(cfg2, generator=torch.Generator(
        device=dev).manual_seed(0), dtype=torch.float32, device=dev)
    res["a_f32"] = _tp_steps(cfg2, params, torch.float32, mesh, dev, rank,
                             SERVE_TP_STEPS)
    del params
    free_device()
    # (a) bf16 at full depth, the fault, the e4m3 pool.
    cfg = LLAMA3_8B
    params = init_llama_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    res["a"] = _tp_steps(cfg, params, torch.bfloat16, mesh, dev, rank,
                         SERVE_TP_STEPS, fault_layer=SERVE_TP_FAULT_LAYER,
                         compress=True)
    free_device()
    res["a_seconds"] = time.perf_counter() - t0

    # (b) ServingEngine(mesh=) serves phase 4's load.
    eng = ServingEngine(cfg, params, mesh=mesh, device=dev,
                        dtype=torch.bfloat16, **SERVE_GEOM)
    eng.serve([Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                       max_new_tokens=2)])
    reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
    tp_set = mesh.group("tp").name
    before = dict(collective_totals().get(("allreduce", tp_set),
                                          {"calls": 0.0, "bytes": 0.0}))
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    rep = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    after = collective_totals()[("allreduce", tp_set)]
    res["b"] = {"report": rep.as_dict(), "launches": counts,
                "streams": {r.rid: list(r.tokens) for r in reqs},
                "tp_allreduces": after["calls"] - before["calls"],
                "tp_allreduce_bytes": after["bytes"] - before["bytes"],
                "leaked": eng.cache.allocated_pages,
                "balanced": eng.cache.refcounts_balanced(),
                "headers": eng._ls.headers,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del eng
    free_device()

    # (c) ServingControlPlane(initial_tp=2), a scripted shrink to 1.
    plane = ServingControlPlane(
        cfg, params, initial_tp=world,
        policy=_ScriptedPolicy({2: Decision("shrink", "scripted",
                                            target_size=1)}),
        policy_config=PolicyConfig(interval_s=0.0, drain_steps=0),
        device=dev, dtype=torch.bfloat16, **SERVE_GEOM)
    reqs = generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))
    emitted = {}
    transition = plane._transition

    def snapshot(*a, **k):
        emitted.update({r.rid: len(r.tokens) for r in reqs})
        return transition(*a, **k)
    plane._transition = snapshot
    registry.reset_launch_counts()
    rep = plane.serve(reqs)
    torch.cuda.synchronize()
    report = rep.as_dict()
    res["c"] = {"report": report, "launches": registry.launch_counts(),
                "streams": {r.rid: list(r.tokens) for r in reqs},
                "emitted_before_shrink": emitted,
                "pages": plane.engine.cache.allocated_pages,
                "in_mesh": plane.engine.in_mesh,
                "metrics_fails": check_ctl_metrics(
                    render_prometheus(), report, len(plane.healthy))}
    del plane, params
    free_device()
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, out)
    hvd.shutdown()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Phase 30: item 1.12's rest -- a tp 2 decode worker in the fleet, and the
# two-level DP leg of the 3-D step
# ---------------------------------------------------------------------------


FLEET_TP = 2                   # (a): the decode worker's ranks on the card
FLEET_TP_KILL_AFTER = 3        # (a): handoffs published before the kill
FLEET_TP_TIMEOUT = 420
FLEET_TP_PAGE = 16
DCN_WORLD = 4                  # (b): dcn 2 x data 2 (and dcn 2 x model 2)
DCN_LAYERS = 24                # (b): BERT-Large's depth, uncut
DCN_TIMEOUT = 300              # (b): its time budget, workers included
DCN_CODEC = "ici:none,dcn:fp16"
DCN_HIER_LEGS = ("hier/ici_rs", "hier/dcn_ar", "hier/ici_ag")


def _first_logits(eng, store: dict):
    """Wrap ``eng``'s decode step: the logits row of every slot taking
    its first decode step (one token so far), by request id, on the
    CPU in f32."""
    step = eng.step

    def spy(*args):
        out = step(*args)
        active = args[6]
        for slot, req in eng.scheduler.active.items():
            if bool(active[slot]) and len(req.tokens) == 1 and \
                    req.rid not in store:
                store[req.rid] = out[0][slot].float().cpu()
        return out
    spy._meta = step._meta
    eng.step = spy


def fleet_tp_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 30 (a): Llama-3 8B at full width and depth on
    ``cuda:0`` over gloo; rank 0 is the fleet's leader and runs its
    prefill worker, every rank the tp 2 decode worker's shard."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.parallel import build_parallel_mesh
    from horovod_tpu_torch.run.http_kv import KVClient
    from horovod_tpu_torch.serving import (DecodeWorker, LoadSpec,
                                           PrefillWorker, ServingEngine,
                                           ServingFleet, generate)
    from horovod_tpu_torch.serving import fleet as fleet_mod
    hvd.init(device=PAR_WORKER_DEVICE)
    dev = torch.device(PAR_WORKER_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, bf16 = LLAMA3_8B, torch.bfloat16
    mesh = build_parallel_mesh(tp=world)
    params = init_llama_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), dtype=bf16, device=dev)
    kv = KVClient("127.0.0.1", int(os.environ["FLEET_TP_KV_PORT"]),
                  os.environ["FLEET_TP_KV_SECRET"])
    res = {"backend": dist.get_backend()}

    def engine(**kw):
        eng = ServingEngine(cfg, params, mesh=mesh, device=dev, dtype=bf16,
                            **SERVE_GEOM, **kw)
        _warm(eng)
        return eng

    def load():
        return generate(LoadSpec(vocab_size=cfg.vocab_size, **SERVE_LOAD))

    # The colocated tp 2 engine on the same load (phase 29 (b)'s).
    eng = engine()
    reqs = load()
    rep = eng.serve(reqs)
    res["colocated"] = {"streams": _streams(reqs),
                        "tokens_per_s": rep.tokens_per_s,
                        "ttft_p50_s": rep.ttft_p50_s,
                        "wall_s": rep.wall_s}
    del eng
    free_device()
    # The same engine with kv_compress, every full prompt page moved to
    # the e4m3 pool as the request joins the decode batch: it reads the
    # e4m3 pages an fp8-wire import lands (demote_page is bitwise the
    # wire's quantisation), so the fp8 fleet's streams must equal its.
    eng = engine(kv_compress=True)
    eng.cache.config = dataclasses.replace(eng.cache.config, hot_pages=0)
    join = eng._join_decode

    def join_cold(st, slot, req, first, now):
        eng.cache.compress_cold(slot)
        join(st, slot, req, first, now)
    eng._join_decode = join_cold
    reqs = load()
    eng.serve(reqs)
    res["colocated_fp8"] = _streams(reqs)
    del eng, join
    free_device()

    # The fp8 wire's imports, each held against the encoder's
    # quantisation: this rank's heads of kq / vq, the row scales whole.
    shard_checks = []
    imp = fleet_mod.import_pages

    def checked_import(cache, slot, wp):
        n = imp(cache, slot, wp)
        if wp.kq is not None and wp.full_pages:
            cp = [int(cache.cpage_table[slot, i])
                  for i in range(wp.full_pages)]
            hs = slice(cache.head0, cache.head0 + cache.local_heads)
            u8 = torch.uint8
            shard_checks.append(all(
                torch.equal(getattr(cache, q)[:, cp].view(u8).cpu(),
                            getattr(wp, q)[..., hs, :].contiguous()
                            .view(u8))
                for q in ("kq", "vq")) and all(
                torch.equal(getattr(cache, s)[:, cp].cpu(), getattr(wp, s))
                for s in ("kscale", "vscale")))
        return n
    fleet_mod.import_pages = checked_import

    def run(tier: str, kill: bool = False) -> dict:
        dec = engine(kv_compress=(tier == "fp8"))
        logits: dict = {}
        _first_logits(dec, logits)
        fleet = ServingFleet(
            [PrefillWorker("p0", cfg, params, kv, page_size=FLEET_TP_PAGE,
                           dtype=bf16, tier=tier, device=dev)],
            [DecodeWorker("decode0", dec, kv)], kv)
        if kill:
            # The prefill worker dies once FLEET_TP_KILL_AFTER handoffs
            # are published: at the import of that one, on every rank.
            worker = fleet.decode["decode0"]
            complete = worker.complete_handoff
            seen = [0]

            def complete_or_die(slot, req, ticket, now, delete=True):
                seen[0] += 1
                if seen[0] == FLEET_TP_KILL_AFTER:
                    fleet.kill_prefill("p0")
                    return None
                return complete(slot, req, ticket, now, delete=delete)
            worker.complete_handoff = complete_or_die
        reqs = load()
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        t1 = time.perf_counter()
        rep = fleet.serve(reqs)
        torch.cuda.synchronize()
        rec = {"report": rep.as_dict(), "launches": registry.launch_counts(),
               "seconds": time.perf_counter() - t1,
               "streams": _streams(reqs), "headers": fleet._ls.headers,
               "pages": dec.cache.allocated_pages,
               "balanced": dec.cache.refcounts_balanced(),
               "alive": fleet.prefill_workers[0].alive,
               "prefills": fleet.prefill_workers[0].prefills}
        return rec, logits

    res["f32"], f32_logits = run("f32")
    free_device()
    res["fp8"], fp8_logits = run("fp8")
    res["fp8"]["shard_checks"] = shard_checks
    res["fp8"]["full_page_requests"] = sum(
        r.prompt_len >= FLEET_TP_PAGE for r in load())
    if rank == 0:
        res["fp8"]["first_logits_rel_err"] = {
            rid: ((fp8_logits[rid] - f32_logits[rid]).abs().max()
                  / f32_logits[rid].abs().max()).item()
            for rid in f32_logits if rid in fp8_logits}
    del f32_logits, fp8_logits
    free_device()
    res["dead"], _ = run("f32", kill=True)
    fleet_mod.import_pages = imp
    res["seconds"] = time.perf_counter() - t0
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    torch.save(res, out)
    hvd.shutdown()
    dist.destroy_process_group()
    return 0


def _update_errs(got: dict, ref: dict, p0: dict) -> dict:
    """``{leaf: ||got - ref|| / ||ref - p0||}``: the distance of a run's
    parameter update from the reference update, over the reference
    update's size (AdamW moves a leaf by about ``lr`` an element whatever
    its gradient, so a max-abs distance saturates; the L2 one counts how
    much of the update moved)."""
    out = {}
    for n, r in ref.items():
        dev = p0[n].device
        r = r.to(dev).float()
        den = (r - p0[n].float()).norm().item()
        out[n] = (got[n].to(dev).float() - r).norm().item() / max(den,
                                                                  1e-30)
    return out


def _update_gate(errs: dict, floor: dict) -> dict:
    """Phase 28's bf16 gate on the updates: each leaf within ``BF16_TOL``
    or ``PAR_BF16_FLOOR_FACTOR`` times the world-1 step's own bf16-vs-f32
    distance (``floor``), whichever is larger."""
    gate = {n: max(BF16_TOL, PAR_BF16_FLOOR_FACTOR * floor[n]) for n in errs}
    margin = min((gate[n] / max(v, 1e-30), n) for n, v in errs.items())
    worst = max((v, n) for n, v in errs.items())
    return {"worst_update_rel_err": worst[0], "worst_leaf": worst[1],
            "margin": margin[0], "margin_leaf": margin[1],
            "leaves_over_gate": sum(v > gate[n] for n, v in errs.items()),
            "ok": margin[0] >= 1.0}


def dcn_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 30 (b): BERT-Large through ``make_train_step`` on
    ``build_3d_mesh(dcn_size=2, data=2)`` and ``(dcn_size=2, model=2)``
    over gloo on ``cuda:0``, ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` (in the
    environment).  Rank 0 holds each run's parameters against the
    world-1 reference the parent saved."""
    import dataclasses as dc

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops as c_ops
    from horovod_tpu_torch.controller.fusion import plan_hier_legs
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import BERT_LARGE, init_bert_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.parallel import (build_3d_mesh, data_axes,
                                            gather_tp_params, tp_param_specs)
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import (bert_pretrain_loss,
                                            make_train_step, shard_batch)
    hvd.init(device=PAR_WORKER_DEVICE)
    dev = torch.device(PAR_WORKER_DEVICE)
    t0 = time.perf_counter()
    cfg = dc.replace(BERT_LARGE, num_layers=DCN_LAYERS)
    p0 = init_bert_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    specs = tp_param_specs(p0, axis="model")
    full_batch = bert_batch(cfg, dev, *PAR_BATCH, seed=0)
    ref = torch.load(os.environ["DCN_REF"], weights_only=False, mmap=True)
    res = {"backend": dist.get_backend(), "layers": cfg.num_layers,
           "hierarchical_allreduce":
               bool(global_state().config.hierarchical_allreduce)}

    def run(mesh, steps: int, compression=hvd.Compression.none,
            zero: bool = False, fault: bool = False) -> dict:
        tp = mesh.axis_size("model")
        model = _bert_tp_model(cfg, dev, p0, specs, mesh, tp)
        named = list(model.named_parameters())
        inner = torch.optim.AdamW([p for _, p in named], lr=1e-3,
                                  weight_decay=1e-4)
        if zero:
            opt = inner
            step = make_train_step(model, bert_pretrain_loss, opt, tp=tp,
                                   param_specs=specs, zero_stage=1)
        else:
            opt = hvd.DistributedOptimizer(
                inner, named_parameters=named, compression=compression,
                process_set=mesh.group(data_axes(mesh)))
            step = make_train_step(model, bert_pretrain_loss, opt, tp=tp,
                                   param_specs=specs)
        batch = shard_batch(full_batch)
        rec = {"mesh": dict(mesh.shape), "losses": [], "step_ms": []}
        all_reduce = dist.all_reduce
        if fault and rank == 0:
            # The DCN leg skipped on this rank: it joins the collective
            # (its peer would hang) but keeps its own partial shard.
            dcn_group = mesh.group("dcn").group

            def skip_dcn(t, *a, group=None, **k):
                if group is dcn_group:
                    return all_reduce(t.clone(), *a, group=group, **k)
                return all_reduce(t, *a, group=group, **k)
            c_ops.dist.all_reduce = skip_dcn
        try:
            before = exchange_totals(legs=True)
            for i in range(steps):
                torch.cuda.synchronize()
                registry.reset_launch_counts()
                t1 = time.perf_counter()
                rec["losses"].append(step(batch).item())
                rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            after = exchange_totals(legs=True)
        finally:
            c_ops.dist.all_reduce = all_reduce
        rec["launches"] = registry.launch_counts()     # the last step's
        rec["legs"] = {k: after[k] - before[k] for k in DCN_HIER_LEGS}
        if not zero:
            pair = opt._process_set.hier
            rec["pair"] = pair.shape
            plan = dict.fromkeys(DCN_HIER_LEGS, 0)
            for dt, lspecs in opt.bucket_plan.buffers:
                for leg in plan_hier_legs(sum(s.size for s in lspecs), dt,
                                          n_dcn=pair.n_dcn,
                                          n_ici=pair.n_ici,
                                          compression=compression):
                    plan[leg.tag] += leg.nbytes * steps
            rec["plan_legs"] = plan
            rec["buckets"] = len(opt.bucket_plan.buffers)
        params = {n: p.detach() for n, p in named}
        if tp > 1:
            params = gather_tp_params(params, specs, axis="model")
        if rank == 0:
            rec["params"] = {n: v.float().cpu() for n, v in params.items()}
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        del model, opt, step, inner, named, params
        free_device()
        return rec

    mesh = build_3d_mesh(data=2, dcn_size=2)
    runs = {"hier": run(mesh, 2), "codec": run(mesh, 1, DCN_CODEC),
            "fault": run(mesh, 2, fault=True)}
    mesh = build_3d_mesh(model=2, dcn_size=2)
    runs["zero"] = run(mesh, 1, zero=True)
    runs["nozero"] = run(mesh, 1)
    if rank == 0:
        for name, steps in (("hier", 2), ("codec", 1), ("fault", 2),
                            ("zero", 1), ("nozero", 1)):
            r = runs[name]
            # Against the world-1 step over the batch split as the data
            # set splits it (dcn 2 x model 2 splits it in two: logged).
            r["gate"] = _update_gate(_update_errs(
                r["params"], ref[f"split_{steps}"], p0),
                ref[f"floor_{steps}"])
            r["gate_whole_batch"] = _update_gate(_update_errs(
                r["params"], ref[f"bf16_{steps}"], p0), ref[f"floor_{steps}"])
            r["loss_rel_err"] = abs(r["losses"][-1] - ref[f"loss_{steps}"]) \
                / abs(ref[f"loss_{steps}"])
        runs["zero"]["vs_nozero"] = _update_gate(_update_errs(
            runs["zero"]["params"], runs["nozero"]["params"], p0),
            ref["floor_1"])
        for r in runs.values():
            r.pop("params", None)
    res["runs"] = runs
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, out)
    hvd.shutdown()
    dist.destroy_process_group()
    return 0


def _dcn_reference(dev, path: str) -> dict:
    """Phase 30 (b)'s reference: the 3-D step at world 1 (NCCL, tp 1,
    phase 28 (a)'s), one and two AdamW steps from the same init -- in
    f32 and bf16 over the whole batch, and in bf16 over the batch split
    in ``DCN_WORLD`` microbatches as the ranks split it
    (``microbatches=``: the same per-shard gradients, summed in f32);
    saved to ``path``: the bf16 parameters of both, the losses and each
    leaf's bf16-vs-f32 update distance (the gate's floor)."""
    import dataclasses as dc

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BERT_LARGE, init_bert_params
    from horovod_tpu_torch.parallel import build_3d_mesh, tp_param_specs
    hvd.init()
    cfg = dc.replace(BERT_LARGE, num_layers=DCN_LAYERS)
    mesh = build_3d_mesh(data=1, model=1)
    p0 = init_bert_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    specs = tp_param_specs(p0, axis="model")
    batch = bert_batch(cfg, dev, *PAR_BATCH, seed=0)
    got, losses = {}, {}
    for dtype, k in ((torch.float32, 1), (PAR_DTYPE, 1),
                     (PAR_DTYPE, DCN_WORLD)):
        model = _bert_tp_model(cfg, dev, p0, specs, mesh, 1)
        model.dtype = dtype
        step = _bert_tp_step(model, specs, mesh, 1, microbatches=k)
        for steps in (1, 2):
            losses[(dtype, k, steps)] = step(batch).item()
            got[(dtype, k, steps)] = {n: p.detach().float().clone()
                                      for n, p in model.named_parameters()}
        del model, step
        free_device()
    out = {}
    for steps in (1, 2):
        out[f"bf16_{steps}"] = {n: v.cpu() for n, v in
                                got[(PAR_DTYPE, 1, steps)].items()}
        out[f"split_{steps}"] = {n: v.cpu() for n, v in
                                 got[(PAR_DTYPE, DCN_WORLD, steps)].items()}
        out[f"loss_{steps}"] = losses[(PAR_DTYPE, DCN_WORLD, steps)]
        out[f"loss_whole_{steps}"] = losses[(PAR_DTYPE, 1, steps)]
        out[f"loss_f32_{steps}"] = losses[(torch.float32, 1, steps)]
        out[f"floor_{steps}"] = _update_errs(
            got[(torch.float32, 1, steps)], got[(PAR_DTYPE, 1, steps)], p0)
    torch.save(out, path)
    hvd.shutdown()
    del got, p0
    free_device()
    return {k: v for k, v in out.items()
            if not k.startswith(("bf16", "split"))}


def _fleet_tp_check(ranks: list, card: str, total: dict) -> list:
    """Phase 30 (a)'s records, one a fleet run (f32 wire, fp8 wire, dead
    prefill worker), from the ranks' results; the launches added to
    ``total``.  Returns the parts that failed."""
    from horovod_tpu_torch.models import LLAMA3_8B
    fails = []
    layers = LLAMA3_8B.num_layers
    n_req = SERVE_LOAD["num_requests"]
    r0 = ranks[0]
    colo = r0["colocated"]["streams"]
    for part in ("f32", "fp8", "dead"):
        rs = [r[part] for r in ranks]
        rep = rs[0]["report"]
        steps = rep["decode_steps"]
        # The leader prefills every published handoff (a reaped one
        # too); every rank runs the local fallbacks.
        prefills = [r["prefills"] + rep["handoffs_local"] for r in rs]
        decode = "flash_decode_fp8" if part == "fp8" else "flash_decode"
        rec = {"phase": "item_1_12_rest", "part": f"a_{part}", "card": card,
               "tp": FLEET_TP, "backend": [r["backend"] for r in ranks],
               **{k: rep[k] for k in (
                   "completed", "handoffs_streamed", "handoffs_local",
                   "kv_bytes_out", "kv_bytes_in", "decode_steps", "wall_s",
                   "tokens_per_s", "ttft_p50_s", "ttft_p99_s")},
               "colocated_tokens_per_s": r0["colocated"]["tokens_per_s"],
               "colocated_ttft_p50_s": r0["colocated"]["ttft_p50_s"],
               "streams_equal_across_ranks": all(
                   r["streams"] == rs[0]["streams"] for r in rs),
               "reports_equal_across_ranks": all(
                   r["report"] == rep for r in rs),
               "streams_equal_colocated": sum(
                   colo.get(rid) == s
                   for rid, s in rs[0]["streams"].items()),
               "leaked_pages": [r["pages"] for r in rs],
               "headers": [r["headers"] for r in rs],
               "launches": [r["launches"] for r in rs],
               "seconds": [r["seconds"] for r in rs]}
        ok = (rep["completed"] == n_req and rec["streams_equal_across_ranks"]
              and rec["reports_equal_across_ranks"]
              and all(r["pages"] == 0 and r["balanced"] for r in rs)
              and (rep["kv_bytes_in"] == rep["kv_bytes_out"] > 0
                   or part == "dead")
              and all(r["launches"][decode] == layers * steps
                      and r["launches"]["flash"] == layers * n
                      for r, n in zip(rs, prefills)))
        if part == "f32":
            ok = ok and rep["handoffs_streamed"] == n_req and \
                rec["streams_equal_colocated"] == n_req
        if part == "fp8":
            checks = [r["shard_checks"] for r in rs]
            errs = rs[0]["first_logits_rel_err"]
            f32_streams = r0["f32"]["streams"]
            cold = r0["colocated_fp8"]
            rec.update(
                imports_checked=[len(c) for c in checks],
                shards_bitwise_encoder=all(all(c) for c in checks),
                streams_equal_colocated_same_e4m3_pages=sum(
                    cold.get(rid) == s
                    for rid, s in rs[0]["streams"].items()),
                stream_agreement_f32_wire=sum(
                    f32_streams.get(rid) == s
                    for rid, s in rs[0]["streams"].items()),
                first_logits_rel_err_vs_f32_wire=errs)
            # Held: the streams against the colocated engine reading the
            # same e4m3 pages; the first decode logits against the f32
            # wire's (other pages) are logged beside.
            ok = ok and rep["handoffs_streamed"] == n_req and \
                rec["shards_bitwise_encoder"] and \
                all(len(c) == rs[0]["full_page_requests"] > 0
                    for c in checks) and \
                rec["streams_equal_colocated_same_e4m3_pages"] == n_req
        if part == "dead":
            rec.update(kill_after=FLEET_TP_KILL_AFTER,
                       prefill_alive=[r["alive"] for r in rs],
                       streams_equal_f32=sum(
                           r0["f32"]["streams"].get(rid) == s
                           for rid, s in rs[0]["streams"].items()))
            ok = ok and rep["handoffs_local"] >= 1 and \
                rep["handoffs_streamed"] + rep["handoffs_local"] == n_req \
                and rec["streams_equal_f32"] == n_req and \
                not any(rec["prefill_alive"])
        rec["ok"] = bool(ok)
        log(rec)
        if not ok:
            fails.append(f"(a) {part}")
        for r in rs:
            _add_counts(total, r["launches"])
    return fails


def item_1_12_rest(dev, card: str) -> dict:
    """Phase 30 (module docstring): (a) the fleet with a tp 2 decode
    worker over the KV wire, Llama-3 8B, two gloo ranks on the card; (b)
    the two-level DP leg of the 3-D step, BERT-Large on dcn 2 x data 2
    (and dcn 2 x model 2), four gloo ranks.  Returns the main path's
    launches (both parts, every rank)."""
    import tempfile

    from horovod_tpu_torch.run.http_kv import RendezvousServer
    from horovod_tpu_torch.run.secret import make_secret_key
    here = os.path.dirname(os.path.abspath(__file__))
    fails, total = [], {}
    # (a)
    t0 = time.perf_counter()
    free_device()
    secret = make_secret_key()
    srv = RendezvousServer(secret, host="127.0.0.1")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ranks = _par_tp_world(
                here, tmp, "fleet_tp", FLEET_TP, FLEET_TP_TIMEOUT,
                env={"FLEET_TP_KV_PORT": str(srv.port),
                     "FLEET_TP_KV_SECRET": secret})
    finally:
        srv.stop()
    seconds_a = time.perf_counter() - t0
    fails += _fleet_tp_check(ranks, card, total)
    log({"phase": "item_1_12_rest", "part": "a", "card": card,
         "seconds": seconds_a, "worker_seconds": [r["seconds"]
                                                   for r in ranks],
         "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks]})
    del ranks
    free_device()
    # (b)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        ref = _dcn_reference(dev, ref_path)
        t_ref = time.perf_counter() - t0
        ranks = _par_tp_world(here, tmp, "parallel_3d_dcn", DCN_WORLD,
                              DCN_TIMEOUT,
                              env={"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                                   "DCN_REF": ref_path})
    seconds_b = time.perf_counter() - t0
    rec = _dcn_check(ranks, ref, card, total)
    rec["reference_seconds"] = t_ref
    rec["seconds"] = seconds_b
    rec["worker_seconds"] = [r["seconds"] for r in ranks]
    log(rec)
    if not rec["ok"]:
        fails.append("(b)")
    if seconds_b > DCN_TIMEOUT:
        fails.append(f"(b) took {seconds_b:.0f} s of its {DCN_TIMEOUT} s")
    log({"phase": "item_1_12_rest", "card": card, "launches": total,
         "ok": not fails})
    if fails:
        raise AssertionError("item_1_12_rest: parts " + ", ".join(fails)
                             + " failed")
    return total


def _dcn_check(ranks: list, ref: dict, card: str, total: dict) -> dict:
    """Phase 30 (b)'s record from the ranks' runs: each run's gate, the
    bytes by leg against the plan, the fault rejected, the launches
    (added to ``total``); ``ok`` says whether it all held."""
    runs = [r["runs"] for r in ranks]
    g = runs[0]
    rec = {"phase": "item_1_12_rest", "part": "b", "card": card,
           "layers": DCN_LAYERS, "world": DCN_WORLD,
           "backend": [r["backend"] for r in ranks],
           "hierarchical_allreduce": [r["hierarchical_allreduce"]
                                      for r in ranks],
           "batch": list(PAR_BATCH),
           "reference_loss": [ref["loss_1"], ref["loss_2"]],
           "reference_loss_whole_batch": [ref["loss_whole_1"],
                                          ref["loss_whole_2"]],
           "floor_max": [max(ref["floor_1"].values()),
                         max(ref["floor_2"].values())]}
    for name in ("hier", "codec", "fault", "zero", "nozero"):
        r = g[name]
        rec[name] = {"mesh": r["mesh"], "losses": r["losses"],
                     "loss_rel_err": r["loss_rel_err"], "gate": r["gate"],
                     "gate_whole_batch": r["gate_whole_batch"],
                     "step_ms": [x[name]["step_ms"] for x in runs],
                     "legs": [x[name]["legs"] for x in runs],
                     "launches": [x[name]["launches"] for x in runs],
                     "peak_mem_bytes": [x[name]["peak_mem_bytes"]
                                        for x in runs]}
        for k in ("pair", "plan_legs", "buckets", "vs_nozero"):
            if k in r:
                rec[name][k] = r[k]
    ok = True
    for name in ("hier", "codec", "nozero"):
        r = rec[name]
        ok = ok and all(legs == g[name]["plan_legs"] for legs in r["legs"]) \
            and g[name]["plan_legs"]["hier/dcn_ar"] > 0
    # dcn 2 x data 2 against the world-1 step; dcn 2 x model 2 (ZeRO-1)
    # against the same mesh without ZeRO (its gate against world 1, which
    # the tp split's own bf16 ordering moves, is logged beside).
    for name in ("hier", "codec", "zero", "nozero"):
        r = rec[name]
        ok = ok and r["loss_rel_err"] <= 1e-2 and \
            all(np.isfinite(r["losses"]))
        if name in ("hier", "codec"):
            ok = ok and r["gate"]["ok"]
    ok = ok and rec["hier"]["pair"] == (2, 2) and \
        rec["nozero"]["pair"] == (2, 1) and rec["zero"]["vs_nozero"]["ok"]
    ok = ok and not rec["fault"]["gate"]["ok"]
    for name in ("hier", "codec", "zero", "nozero"):
        for c in rec[name]["launches"]:
            for f in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
                ok = ok and c[f] == DCN_LAYERS
            _add_counts(total, c)
    rec["ok"] = bool(ok)
    return rec


TP_JOBS = {"parallel_3d": tp_worker, "serving_tp": serving_tp_worker,
           "fleet_tp": fleet_tp_worker, "parallel_3d_dcn": dcn_worker}


def serving_tp(dev, card: str, serve_run: dict) -> dict:
    """Phase 29 (module docstring): Llama-3 8B at tp 2 as two gloo ranks
    on the one card -- (a) the teacher-forced step against tp 1, the
    skipped-sum fault, f32 greedy agreement and the e4m3 pool; (b)
    ``ServingEngine(mesh=)`` on phase 4's load; (c) the control plane's
    scripted shrink.  Returns the main path's launches ((b) and (c), both
    ranks)."""
    import tempfile
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    free_device()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _par_tp_world(here, tmp, "serving_tp", SERVE_TP,
                              SERVE_TP_TIMEOUT)
    seconds = time.perf_counter() - t0
    from horovod_tpu_torch.models import LLAMA3_8B
    fails, total = [], {}
    layers = LLAMA3_8B.num_layers
    r0 = ranks[0]
    # (a)
    a = r0["a"]
    worst = max(s["rel_err"] for s in a["steps"])
    rec_a = {"phase": "serving_tp", "part": "a", "card": card,
             "tp": SERVE_TP, "backend": [r["backend"] for r in ranks],
             "steps": len(a["steps"]),
             "rel_err_each": [s["rel_err"] for s in a["steps"]],
             "worst_rel_err": worst, "tol": BF16_TOL,
             "greedy_equal_bf16": [s["greedy_equal"] for s in a["steps"]],
             "fault_layer": SERVE_TP_FAULT_LAYER,
             "fault_rel_err": a["fault"]["rel_err"],
             "f32_layers": SERVE_TP_F32_LAYERS,
             "f32_rel_err_each": [s["rel_err"]
                                  for s in r0["a_f32"]["steps"]],
             "f32_greedy_equal": [s["greedy_equal"]
                                  for s in r0["a_f32"]["steps"]],
             "compressed_pages": a["compressed_pages"],
             "e4m3_shards_equal": a["e4m3_shards_equal"],
             "compressed_step_bitwise_plain_step_on_dequantised_pool": [
                 r["a"]["compressed_step"][
                     "bitwise_plain_step_on_dequantised_pool"]
                 for r in ranks],
             "launches_a_step": [[s["launches"]["flash_decode"]
                                  for s in r["a"]["steps"]] for r in ranks],
             "fp8_launches": [r["a"]["compressed_step"]["launches"][
                 "flash_decode_fp8"] for r in ranks],
             "seconds": r0["a_seconds"]}
    rec_a["ok"] = (worst <= BF16_TOL
                   and a["fault"]["rel_err"] > BF16_TOL
                   and all(s["finite"] for s in a["steps"])
                   and all(rec_a["f32_greedy_equal"])
                   and a["e4m3_shards_equal"] and a["compressed_pages"] > 0
                   and all(rec_a["compressed_step_bitwise_plain_step_on_"
                                 "dequantised_pool"])
                   and all(n == layers for r in rec_a["launches_a_step"]
                           for n in r)
                   and rec_a["fp8_launches"] == [layers] * SERVE_TP)
    log(rec_a)
    if not rec_a["ok"]:
        fails.append("(a)")
    # (b)
    b = [r["b"] for r in ranks]
    rep = b[0]["report"]
    steps = rep["decode_steps"]
    plain = serve_run["streams"]
    agree = sum(plain.get(rid) == s for rid, s in b[0]["streams"].items())
    rec_b = {"phase": "serving_tp", "part": "b", "card": card,
             "completed": rep["completed"], "decode_steps": steps,
             "prefills": rep["prefills"],
             "token_latency_p50_s": rep["token_latency_p50_s"],
             "token_latency_p99_s": rep["token_latency_p99_s"],
             "ttft_p50_s": rep["ttft_p50_s"], "ttft_p99_s": rep["ttft_p99_s"],
             "tokens_per_s": rep["tokens_per_s"],
             "wall_s": rep["wall_s"],
             "phase4": {k: serve_run["report"][k] for k in (
                 "token_latency_p50_s", "token_latency_p99_s",
                 "ttft_p50_s", "ttft_p99_s", "tokens_per_s")},
             "streams_equal_across_ranks": b[1]["streams"] ==
             b[0]["streams"],
             "reports_equal_across_ranks": b[1]["report"] == rep,
             "streams_equal_phase4": agree,
             "tp_allreduces_a_step": [x["tp_allreduces"] / max(steps, 1)
                                      for x in b],
             "tp_allreduce_bytes_a_step": [x["tp_allreduce_bytes"]
                                           / max(steps, 1) for x in b],
             "launches": [x["launches"] for x in b],
             "leaked_pages": [x["leaked"] for x in b],
             "headers": [x["headers"] for x in b],
             "peak_mem_bytes": [x["peak_mem_bytes"] for x in b]}
    rec_b["ok"] = (rep["completed"] == SERVE_LOAD["num_requests"]
                   and rec_b["streams_equal_across_ranks"]
                   and rec_b["reports_equal_across_ranks"]
                   and all(x["leaked"] == 0 and x["balanced"] for x in b)
                   and all(n == 2 * layers
                           for n in rec_b["tp_allreduces_a_step"])
                   and all(x["launches"]["flash_decode"] == layers * steps
                           and x["launches"]["flash"]
                           == layers * rep["prefills"] for x in b))
    log(rec_b)
    if not rec_b["ok"]:
        fails.append("(b)")
    # (c)
    c = [r["c"] for r in ranks]
    rep_c = c[0]["report"]
    before = c[0]["emitted_before_shrink"]
    undisturbed = b[0]["streams"]
    prefix_equal = all(c[0]["streams"][rid][:n] == undisturbed[rid][:n]
                       for rid, n in before.items())
    rec_c = {"phase": "serving_tp", "part": "c", "card": card,
             "completed": rep_c["serving"]["completed"],
             "lost_requests": rep_c["lost_requests"],
             "drain_leaked_pages": rep_c["drain_leaked_pages"],
             "resizes": rep_c["resizes"],
             "mesh_size_final": rep_c["mesh_size_final"],
             "drained_reprefilled": rep_c["drained_reprefilled"],
             "decision_counts": rep_c["decision_counts"],
             "tokens_before_shrink": sum(before.values()),
             "prefix_equal_undisturbed": prefix_equal,
             "streams_equal_undisturbed": sum(
                 undisturbed.get(rid) == s
                 for rid, s in c[0]["streams"].items()),
             "reports_equal_across_ranks": c[1]["report"] == rep_c,
             "in_mesh_after": [x["in_mesh"] for x in c],
             "metrics_fails": c[0]["metrics_fails"],
             "launches": [x["launches"] for x in c],
             "pages": [x["pages"] for x in c]}
    rec_c["ok"] = (rep_c["serving"]["completed"]
                   == SERVE_LOAD["num_requests"]
                   and rep_c["lost_requests"] == 0
                   and rep_c["drain_leaked_pages"] == 0
                   and rep_c["resizes"] == 1
                   and rep_c["mesh_size_final"] == 1 and prefix_equal
                   and rec_c["reports_equal_across_ranks"]
                   and not c[0]["metrics_fails"]
                   and rec_c["pages"] == [0] * SERVE_TP)
    log(rec_c)
    if not rec_c["ok"]:
        fails.append("(c)")
    for r in ranks:
        _add_counts(total, r["b"]["launches"])
        _add_counts(total, r["c"]["launches"])
    log({"phase": "serving_tp", "card": card, "seconds": seconds,
         "worker_seconds": [r["seconds"] for r in ranks],
         "launches": total, "ok": not fails})
    if fails:
        raise AssertionError("serving_tp: parts " + ", ".join(fails)
                             + " failed")
    return total


def main(argv=None) -> int:
    """Every phase (``--tp-worker <job>``: one rank of phase 28 (b), 29
    or 30)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--tp-worker"]:
        return TP_JOBS[argv[1]](int(argv[2]), int(argv[3]), argv[4],
                                argv[5])
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as attn
    from horovod_tpu_torch.ops import bn

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "nvidia_smi": card, "kind": kind,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})
    log({"phase": "build", "seconds": _build.build_all(),
         "nvcc": _build.nvcc_path(), "flags": _build.NVCC_FLAGS,
         "tensor_core_kernels": mma_resources(_build)})

    flash = check_flash(attn, dev)
    decode = check_decode(attn, dev)
    decode_fp8 = check_decode_fp8(attn, dev)
    free_device()
    check_decode_tp(attn, dev)
    free_device()
    dq, dkv = check_flash_bwd(attn, dev)
    free_device()
    check_bert_attention(attn, dev, card)
    free_device()
    bn_red, bn_dx = check_bn_bwd(bn, dev)
    free_device()
    fused = check_fused_update(dev)
    free_device()
    serve, serve_run = serve_llama(dev, card)
    free_device()
    check_grad(dev)
    free_device()
    train, train_run = train_llama(dev, card)
    free_device()
    check_resnet_grad(dev)
    free_device()
    resnet = train_resnet(dev, card)
    free_device()
    powersgd = train_resnet_powersgd(dev, card)
    free_device()
    train_lenet(dev)
    free_device()
    check_bert_grad(dev)
    free_device()
    bert = train_bert(dev, card)
    bert_step_ms = bert.pop("step_ms")
    free_device()
    check_bn_sync(dev, card)
    free_device()
    inception = train_cnn("inception_train", "inception_v3", dev, card,
                          INCEPTION_BN_SITES)
    free_device()
    train_cnn("vgg_train", "vgg16", dev, card, 0)
    free_device()
    fused_update_launches(dev, card)
    free_device()
    check_torch_api(dev, card)
    free_device()
    train_torch_mnist(card)
    free_device()
    torch_rn50 = train_torch_resnet50(dev, card)
    free_device()
    exchange = train_resnet_exchange(dev, card)
    free_device()
    loop = train_resnet_loop(dev, card)
    free_device()
    elastic_bn, commit_ms = elastic_resnet(dev, card, resnet["step_ms"])
    free_device()
    sdc_bn = sdc_resnet(dev, card, resnet["step_ms"], commit_ms)
    free_device()
    autotune_bn = autotune_resnet(dev, card, resnet["step_ms"])
    free_device()
    join_bn = eager_join(dev, card)
    free_device()
    lora26 = lora_int8_serve(dev, card, train_run, serve_run)
    free_device()
    rest27 = serving_rest(dev, card, serve_run)
    free_device()
    par28 = parallel_3d(dev, card, bert_step_ms)
    free_device()
    tp29 = serving_tp(dev, card, serve_run)
    free_device()
    rest30 = item_1_12_rest(dev, card)
    free_device()
    # The attention and BN kernels run on several paths: their launches
    # are the sums.
    flash["launches"] = (serve["flash"] + train["flash"] + bert["flash"]
                         + lora26["flash"] + rest27["flash"]
                         + par28["flash"] + tp29["flash"]
                         + rest30["flash"])
    decode["launches"] = (serve["flash_decode"] + lora26["flash_decode"]
                          + rest27["flash_decode"] + tp29["flash_decode"]
                          + rest30["flash_decode"])
    decode_fp8["launches"] = (rest27["flash_decode_fp8"]
                              + rest30["flash_decode_fp8"])
    dq["launches"] = (train["flash_bwd_dq"] + bert["flash_bwd_dq"]
                      + lora26["flash_bwd_dq"] + par28["flash_bwd_dq"]
                      + rest30["flash_bwd_dq"])
    dkv["launches"] = (train["flash_bwd_dkv"] + bert["flash_bwd_dkv"]
                       + lora26["flash_bwd_dkv"] + par28["flash_bwd_dkv"]
                       + rest30["flash_bwd_dkv"])
    bn_red["launches"] = (resnet["bn_bwd_reduce"] + inception["bn_bwd_reduce"]
                          + torch_rn50["bn_bwd_reduce"]
                          + exchange["bn_bwd_reduce"]
                          + loop["bn_bwd_reduce"]
                          + elastic_bn["bn_bwd_reduce"]
                          + sdc_bn["bn_bwd_reduce"]
                          + autotune_bn["bn_bwd_reduce"]
                          + join_bn["bn_bwd_reduce"]
                          + par28["bn_bwd_reduce"])
    bn_dx["launches"] = (resnet["bn_bwd_dx"] + inception["bn_bwd_dx"]
                         + torch_rn50["bn_bwd_dx"] + exchange["bn_bwd_dx"]
                         + loop["bn_bwd_dx"] + elastic_bn["bn_bwd_dx"]
                         + sdc_bn["bn_bwd_dx"] + autotune_bn["bn_bwd_dx"]
                         + join_bn["bn_bwd_dx"] + par28["bn_bwd_dx"])
    for e in fused:
        e["launches"] = powersgd[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log({"kernels": [{k: e[k] for k in keys}
                     for e in (flash, decode, decode_fp8, dq, dkv, bn_red,
                               bn_dx, *fused)]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
