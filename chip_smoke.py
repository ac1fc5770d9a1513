#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout:
python3 chip_smoke.py [--before DIR] [--seed N] [--only PHASE[,PHASE]]

The bare call runs every phase below; ``--only`` runs the named ones
(``kernels``: steps 3, 4, 5c; ``serving``: 5-5e; ``training``: 6;
``train_resume``: 6a and its recovery ladder; ``memory_recipes``: 6b; ``lora_train``: 6c;
``examples``: 6d; ``parallel``: 6e; ``moe``: 6f; ``fleet_fabric``: 6g;
``sharded_ckpt``: 6h; ``sharded_recipes``: 6i; ``tp_serving``: 6j) and
prints the kernels line for the kernels they reached.

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc`` with
   nvcc (``sm_90a``), one nvcc per source, all started together, and
   reports the build times;
3. holds each paged kernel (#4, #6) against its plain PyTorch version at
   the shapes of the 600m serving model (block tables of distinct pages, as
   the allocator hands them out; #4 also at the same tokens over pages of
   32 and at ``generate_paged``'s 4 slots over pages of 16, #6 also at
   ``generate_paged``'s pages of 16 and over pages of 32), and times the
   kernel, the plain version and one ``F.scaled_dot_product_attention``
   call over the gathered KV (a yardstick only; the port never calls it)
   beside the least time the card could take (bytes over 3.35 TB/s or
   flops over 989 TFLOP/s bf16); the same for the quantized paged kernels
   (#5, #7) over int8 and fp8 pages written by the port's own
   ``paged_write_kv_quantized`` (SDPA over the dequantized gathered KV as
   the yardstick; #5 at the same three decode cases, #7 also at
   ``generate_paged``'s pages of 16, 4 prompts of 250 tokens, and over
   pages of 32); requires #4 / #5 to give bitwise-equal outputs over 21
   launches on the same operands and for each slot alone and in the
   16-slot batch, and prints ptxas's registers and spills for each
   instance of ``paged_decode.cu``; and for the W8A16 matmuls at the 600m
   model's four dense shapes and one H with a partial K tile: #11 at m 16,
   64, 65 (its plan switch) and 512, #12 at m 1, 4 and 8 (``F.linear`` on
   the dequantized bf16 weight as the yardstick), #12 also on two streams
   at once (bitwise) and with ptxas's registers and spills of each
   instance.  With ``--before DIR`` (a checkout of an earlier commit, such
   as ``git archive`` of it unpacked under ``build/``), #4 / #5 as DIR's
   ``paged_attention.cu`` built them (one block per slot and kv head, pages
   in turn), where it has them, and #12 as DIR's ``quantized_matmul.cu``
   builds it (both its launches, on DIR's split rule), where it has that
   design, are held to their plain versions and timed beside the new ones
   (``before_ms``);
4. holds the flash-attention kernels (#1 forward, #2 dq, #3 dk/dv) against
   their plain versions at the 600m training shapes (16 q / 8 kv heads,
   head dim 96, T 2048): at batch 2 causal, segments, positions,
   non-causal, T not a multiple of the tile, and a nonzero logsumexp
   gradient; at the main path's batch 10 causal; runs #2 and #3 twice and
   requires bitwise-equal dq and dk/dv, then launches both 20 times back
   to back on the same operands and requires every output bitwise equal to
   the first; times the three kernels, their plain versions and SDPA's
   forward and backward at batch 10; prints ptxas's registers and spills
   for ``flash_attention.cu`` and, for #2 and #3, the ``HGMMA`` and
   ``WARPGROUP.DEPBAR`` counts of their SASS (``cuobjdump -sass``).  With
   ``--before DIR`` the #2 and #3 of DIR's ``flash_attention.cu`` (built
   from DIR with its headers) are held to their plain versions at batch 10
   and timed beside the new ones (``before_ms``);
5. serves a 16-request trace (prompts 64-512, 32-128 new tokens: the
   bench trace's 32-256 cut to 128, the overload storm's trace excepted,
   so the script fits its time limit) on the 600m Llama (random weights
   from seed 0) through ``ServingEngine`` under ``torch.inference_mode()``, checks
   that every request finishes, that the host page mirror agrees with the
   device allocator and that each kernel launched once per layer of every
   decode / prefill step; serves the trace again on a fresh engine with
   every kernel launch held against its plain version on the engine's own
   operands (every such checked rerun caps each request at
   ``CHECKED_NEW`` = 64 new tokens, ``generate_paged``'s at 16: the
   script's time limit); then teacher-forces two of the served sequences through the
   model with the kernels and with their plain versions; then does all of
   that again with int8 weights (``quantize_model_``) and int8 KV pages
   (#5, #7 and #11 launched once per layer and dense of every step, #12
   never; the pool's bytes per page equal to ``kv_page_bytes``), and
   reports its tokens/s, latencies, weight and pool bytes beside the bf16
   serve's; then serves 8 of the requests from int8 pages of 32 tokens
   under ``decode_kernel="auto"`` (#5 and #7 once per layer of every step,
   every request finishing), and again with every launch held against its
   plain version;
5a. speculative decode (``bench.py --serve --speculate 4``): the same
   trace with prompt-lookup drafting, k 4, every verify pass kernel #6 at
   [16, 5] (the host wall and kernel launches of each tick kind reported);
   tokens held to the bf16 serve's greedy tokens under the token rule
   (equal, or first different where the reference's two tokens are a
   near-tie: their logit gap no larger than the largest |logit difference|
   between the kernel route and the plain route, teacher-forced); a
   checked rerun holds every launch against its plain version with the
   serving resource contract checked after every tick; if no draft is
   accepted, 8 prompts repeating a 5-token cycle serve too; then 4
   requests through a 2-layer draft model at the 600m widths (kernel #1
   at T 32, every launch held to its plain version);
5a'. after the quantized serves: the prefix cache (``bench.py --serve
   --prefix-share 0.5``, with ``--speculate 4``): the shared-preamble
   trace with both features off, then on (hit rate beside its prediction,
   shared pages, forks, skipped prefill, TTFT off and on, tokens under the
   token rule), a checked rerun with the resource contract after every
   tick, then the int8 model from int8 pages on its first 4 requests the
   same way (#7 at [16, 5], #11 at m 80);
5a''. overload, disaggregation and the fleet: 32 requests of the bench
   trace through the speculative bf16 engine with a bounded queue, a
   KV-pressure watermark and a default deadline, by ``chaos_replay`` under
   a seeded cancel / deadline storm, the degradation ladder escalated at
   fixed ticks and by the storm through despeculate (#4 from then on),
   shrink_prefill (#6 at the smallest bucket), tighten_admission and shed:
   sheds, deadline misses and cancels each occur, the survivors' tokens
   meet the token rule against a fault-free serve of the survivors, and a
   checked rerun of the storm holds every #4 / #6 launch to its plain
   version with the resource contract after every tick; then
   ``bench.py --serve --disaggregate``'s prefill -> decode pair over the
   bf16 trace (#6 prefill, #4 decode) and over int8 weights and pages on
   4 requests (#7 / #11, #5 / #11): page bytes equal to
   ``transfer_accounting``, each slot's gather and scatter (CUDA events)
   beside its bound, tokens/s beside the fused serve's, tokens under the
   token rule, a checked rerun with the contract on both engines after
   every tick; then ``bench.py --serve --fleet 2``'s router over two bf16
   engines on the prefix-share trace, under ``affinity`` and
   ``round_robin`` (hit rate, routed-by counts, per-replica occupancy,
   the token rule), and a ``replica_kill`` at fleet tick 40: the drained
   requests re-route exactly once, the survivors meet the token rule, the
   fault-free placements repeat;
5a'''. big-model inference from a checkpoint (``big_model_phase``): the
   bf16 serve's weights written as 3 HF safetensors shards and an index;
   ``load_checkpoint_and_serve`` into a model built under
   ``init_empty_weights`` (the weights bitwise, the 16 requests capped at
   ``CHECKED_NEW`` served to the in-process serve's tokens bitwise, #4 / #6
   once per layer of every step, a checked rerun of 4 requests); then
   ``load_and_quantize_model`` (codes and scales bitwise
   ``quantize_model_``'s from the same bf16 weights, its peak device memory
   under the int8 model + 7x the largest bf16 weight) served from int8
   pages (#5 / #7 / #11, the token rule against the in-process int8 serve,
   a checked rerun); both tiered by ``infer_auto_placement`` over 40 % of
   their bytes on the card and 6 layers of pinned host memory, the rest
   on disk, and decoded by ``generate_streamed`` at B 4, T 128, 32 new
   tokens: logits bitwise with prefetch on and off, tokens bitwise with
   the disk tier swapped for pinned copies and with ``generate`` on the
   resident model, peak device memory under two layers in flight + the
   KV cache + the captured logits + 64 MiB, the int8 one through #11 at
   prefill and #12 at decode, held to plain; the compute stream's waits
   on staged layers timed by CUDA events beside a bare pinned copy of one
   layer; then ``beam_search`` (4 beams, B 2, 32 new tokens) on the bf16
   and int8 models: one beam equal to greedy, the best beam's
   log-probability a token at least greedy's, the int8 one's #11 / #12
   held to plain;
5b. decodes 4 prompts of 128-256 tokens, 32 new tokens each, through
   ``generate_paged`` with int8 weights and fp8 pages (#12 on every decode
   step, #11 on every prefill chunk, #5 / #7 over fp8 pages), then again
   with every launch of the four held against its plain version, under
   ``torch.profiler``: one device kernel per #12 call; then the same with
   the bf16 model over bf16 pages (#4, #6);
5c. holds the LoRA kernel #10 with the select folded in (``bgmv_apply``)
   against its plain composition at the 600m q_proj (1536 -> 1536) and
   v_proj (1536 -> 768) shapes, 16 slots, rank 16, ids mixing 0 and 1..4:
   bitwise the select over the kernel's own delta, id-0 rows ``y``
   bitwise; holds the delta alone (``bgmv``) to ``bgmv_plain``; and times
   both (20 launches in a CUDA graph) beside its plain version, its bound,
   the delta and the three elementwise launches it replaces, and the
   gathered ``torch.bmm`` pair (a yardstick only); prints ptxas's registers
   and spills of each instance.  With ``--before DIR``, DIR's #10 plus
   those three launches are held to the plain composition and timed the
   same way (``before_ms``);
5d. serves the same 16-request trace with 8 tenants' rank-16 LoRA adapters
   on q_proj and v_proj (``bench.py --serve --adapters 8``: a pool of 4
   slots, so the trace hot-swaps) through ``AdapterStore`` and
   ``ServingEngine(adapters=)``: every request finishes, the page mirror is
   in sync, #10 (``bgmv_apply``) launches for both targets of every layer
   on every decode step (#4 / #6 as in the bf16 serve), each swap moves
   one adapter's 2,752,512 bytes; a second serve holds every #10 and paged
   launch against its plain version on the engine's own operands, and a
   teacher-forced rerun of one adapter request through kernels and plain
   versions agrees;
   reports its tokens/s, latencies, pool hit rate (measured and predicted),
   swaps and swap bytes beside the bf16 serve's;
5e. drives the fused LoRA-query + paged-decode op (#8 over bf16 pages, #9
   over int8 and fp8 pages) on a LoRA engine's own operands after its
   decode ticks (layer 0's pages, block tables, positions, q_proj stacks,
   normed input and roped base q), and on #4 / #5's 16-slot case, held
   against its plain version and against the composed route (#10's delta,
   rope, #4 / #5), requires 21 launches bitwise equal and the rows of id-0
   slots bitwise equal to #4's / #5's output on the base q, prints ptxas's
   registers and spills of each #8 / #9 instance of ``paged_decode.cu``,
   and times it beside its plain version, the composed route and the
   composed route with SDPA over the gathered pages; with ``--before DIR``
   also DIR's #8 / #9 (from its ``paged_attention.cu``, or from its
   ``paged_decode.cu`` where it has no such file), held to the plain
   version (``before_ms``);
6. trains the 600m Llama (bench.py's training step: bf16, flash attention,
   lion-sr on bf16 params, bf16 gradients, fused linear + CE over 4 vocab
   chunks, batch 10 x 2048 of seeded random tokens, the same batch every
   step) through ``Accelerator.create_train_state`` /
   ``prepare_train_step``: 2 warm-up steps, then timed steps with their
   losses, step time, tokens/s, MFU against 989 TFLOP/s and peak memory;
   checks that every kernel launched once per layer per step and that the
   losses are finite and fall; holds every kernel launch of one more
   batch-10 step, and of a batch-2 step, against its plain version on the
   step's own operands; checks that one step at batch 2 through the
   kernels and through their plain versions agrees (loss, grad norm and
   every leaf's gradient);
6a. the resumable training loop (``train_resume_phase``): the same 600m
   step through ``acc.prepare(DataLoader(...))`` over 40 token rows made
   from ``--seed`` (seedable sampler, the native prefetch ring; the loss
   times the batch's float ``weight`` of 1, a leaf for the NaN fault), with
   the NaN guard and the preemption handler on; 6 steps twice with a
   ``nan_grad`` fault at step 5 (the run-to-run check); then a run saving
   after step 2, asynchronously after step 3 (step 4 runs at once,
   updating the params in place under the write) and after step 4, a
   ``FaultPlan`` corrupting that save (bitflip) and sending ``nan_grad``
   and ``preempt`` at step 5: exit code 75 from the emergency checkpoint;
   then ``maybe_resume`` in a fresh Accelerator over a model from another
   init, step 6 and one more step with every #1-#3 launch held against
   its plain version; then, the emergency checkpoint corrupted too, a
   fresh ``load_state()`` must walk past both corrupt checkpoints to the
   async one and find step 3's values there.  Checks the NaN step left
   params, momentum and count bitwise, ``nan_skips`` 1 after the resume,
   the batch stream and the final state equal to the straight run's
   (bitwise where the two straight runs agree, else within their spread),
   the goodput counters, #1-#3 16 launches a step through the loader, and
   the native IO engine in use; prints the ``train_resume`` line (save
   sync / async blocking / async total ms, bytes and GB/s, crc32, verify
   and load ms, data wait, peak memory, the verdicts, the card); then
   (h) the recovery ladder (``recovery_ladder``) on the 600m step at 2 x
   2048 in one process with ``ResiliencePlugin(peer_snapshot_every=2)``:
   an uninterrupted reference pass, a ``rank_loss`` at step 5 recovered
   by ``Accelerator.recover`` from the peer rung (wave 4: the odd rank out
   is its own buddy), a ``partial_ckpt`` tearing wave 4 (dropped by its
   crc, wave 2 restored), ``forget_local()`` falling to the disk rung (a
   checkpoint at step 2) and ``reset()`` with the checkpoints gone (a
   fresh start); each restoring pass continues bitwise with the
   reference, every #1-#3 launch of the faulted passes held to its plain
   version, the snapshot's bytes equal to ``peer_ckpt_accounting``; times
   phase 1's pinned copy and crc32s beside the step, each rung's restore
   and one ``straggler`` stall;
6b. the memory and precision recipes (``memory_recipes_phase``): bench.py's
   1.34B config (``_1b_config``: hidden 2048, 24 layers, 16 heads of 128,
   flash, bf16) at batch 3 x 2048, fused CE over 4 vocab chunks,
   ``lion-sr8`` at block 128, from one seeded state with remat off,
   ``full`` and ``dots`` (2 warm and 3 timed steps each: step ms, MFU,
   peak memory, the memory the forward leaves for the backward; #1 48
   launches a step under remat, 24 off; params, int8 codes and scales
   after 2 steps bitwise across the three), then the scanned stack with
   ``remat_policy="offload"`` and half of each boundary on the host (the
   first loss bitwise the unrolled run's, the second within 1e-3, the
   boundary bytes a step as predicted, the timed steps' own peak below
   ``full``'s; for both, what was live at one step's peak by the source
   line that allocated it); the 600m step under fp16 (an f16 model over f32
   masters: losses finite and falling, the loss-scale sequence, an
   injected overflow leaving params and optimizer state bitwise, the
   scale halved; #1-#3's f16 instances held to their plain versions at
   batch 2 and 10 at f16's limits (``KERNEL_TOL_F16``, half an f16 step),
   #2 / #3 21 launches bitwise, timed beside the bf16
   instances and SDPA's f16 call); under fp8 delayed scaling beside bf16
   over the same batches (losses within 5 %, tokens/s, 3 fp8 products a
   dense a step; each ``torch._scaled_mm`` product at the four dense
   shapes held to its plain version, forward e4m3 x e4m3, backward e5m2 x
   e4m3, timed beside ``F.linear``); and under ZeRO-offload with
   ``lion-sr8`` (resident, then the monolithic, chunked serial and chunked
   pipelined host updates at 0.25 GiB, 1 step each: the monolithic equal
   to resident and pipelined to serial bitwise, params, codes and scales;
   the device-to-host and host-to-device bytes a step equal to
   ``offload_transfer_accounting``; step and host-update ms and the share
   of the copy hidden under the update);
6c. multi-tenant LoRA fine-tuning (``lora_train_phase``): ``LoraTrainer``
   on the 600m model at full width and depth, the base frozen, 8 tenants'
   rank-16 q_proj / v_proj adapters (``lion-sr8``, a pool of 4), a batch of
   8 x 1024 seeded tokens with tenant ids [1, 2, 3, 4, 0, 1, 2, 3] (one
   base row; tenants 5-8 take no rows), 5 steps: #1-#3 16 launches each a
   step, losses finite and the last two's mean below the first, step 1's
   batched loss within 1e-2 of ``sequential_loss`` (and again at the
   trained adapters, where each tenant's slice of the batched gradients is
   held to ``sequential_grads``, a backward over its rows alone, and two
   faulty schedules, rows dropped and tenants swapped, must fail that
   limit), tenants 5-8's weights and state bitwise unchanged,
   the verified save and a load into a fresh trainer bitwise on every leaf
   with the next step's loss bitwise equal in both, a truncated shard
   refused, one more step with every #1-#3 launch held to its plain
   version; prints step ms, tokens/s, the host unpark / park ms a step and
   ``host_state_report()`` beside ``adapter_state_accounting``;
6d. the examples (``examples_phase``): ``BertConfig.base()`` under bf16
   at batch 32 x 128 through a prepared loader, ``adamw``, 5 steps with a
   JSONL tracker logged each step, ``ProfileKwargs(wait=1, warmup=1,
   active=2)`` (steps 2 and 3 traced, the trace file written) and the
   training timeline on, then ``prepare_eval_step`` +
   ``gather_for_metrics`` over 2 batches; the same 5 steps with the
   timeline off give bitwise the same losses, ``step_dispatch`` counted
   once a step; then ``ResNetConfig.resnet50()`` at 224^2 x 3, batch 32, 3
   steps with ``has_aux``, the batch statistics folded back each step;
   prints step ms and peak memory (``get_device_memory_stats``);
6e. data and context parallelism (``parallel_phase``): (a) a world of one
   process over NCCL (``init_process_group`` with a ``file://`` rendezvous),
   the 600m model at full width and depth in bf16 with lion-sr, 4 steps
   at 4 x 2048 through prepared loaders under ``ParallelismConfig()`` and
   ``FULL_SHARD``, held bitwise (params, momentum, count, losses) to the
   same 4 steps of the single-process step from one copy of the state
   (each side's median step ms after its first);
   ``gather`` / ``reduce`` / ``broadcast`` / ``pad_across_processes`` /
   ``gather_for_metrics`` identities on the card; the group destroyed.
   (b) a virtual zigzag ring of cp 4 in one process at the 600m attention
   width (B 1, T 8192, 16 q / 8 kv heads, D 96, bf16, causal; also 3
   packed segments): 16 launches each of #1 / #2 / #3 per pass (positions
   and an lse cotangent), out / dq / dk / dv held to the same ring on the
   plain versions (``held_to_plain``) and to one unsharded causal call of
   #1-#3 (within one bf16 rounding of |ref|); prints the ring's fwd + bwd
   ms beside the unsharded call's and the ring's peak memory.
   (c) Ulysses over a virtual sp 4 world in one process
   (``parallel/virtual.VirtualMesh``: each rank a thread, in turn, the
   all_to_alls in-memory re-layouts of the ranks' tensors) on (b)'s inputs
   and packed segments: each rank's ``make_ulysses_attention`` runs #1-#3
   over its 4 q / 2 kv heads at the full T, causal by index: 4 launches
   each a pass, held to the same world on the plain versions and to one
   unsharded call; fwd + bwd ms beside the unsharded call's and (b)'s
   ring, peak memory.
   (d) tensor parallelism over a virtual tp 4 world: the 600m model's
   forward + backward at 4 x 2048 through each rank's own module replica
   on its tp slices (the same per-rank code as the CPU gangs: vocab-
   parallel embedding and fused CE, column / row denses, #1-#3 at 4 q / 2
   kv heads), collective-matmul modes off and ring: 64 launches each of
   #1-#3 a step; the loss, the grad norm and every re-assembled leaf
   gradient held to the unsharded step's on the same weights and batch
   (loss 1e-3, norm 2 %, each leaf 5 %), ring to off the same way; step
   ms beside the unsharded step's, one profiled step's top items.
   (e) pipeline parallelism over a virtual pp 4 world: the 600m model
   (random weights from seed 0) through ``prepare_pipeline`` at 8 x 2048
   in 8 microbatches of one row, 4 layers a stage: 128 launches each of
   #1-#3 a step (no work on bubble ticks), every launch held to its plain
   version, the logits against the unsharded model's (2e-2 of its
   largest), the loss, the grad norm and every re-assembled leaf gradient
   under the batch-2 rule of the unsharded fwd + bwd; ms and peak memory
   beside the unsharded step's, one profiled step;
   (g) multi-node data parallelism (``virtual_dcn``): the 600m model's
   fwd + bwd for each rank of a virtual dcn 2 x dp_shard 2 world on its
   row of a 4 x 2048 batch (#1-#3 held to their plain versions, 64
   launches each), then through ``VirtualMesh.run`` the dense
   ``hierarchical_sync`` against the flat mean of the four f32 gradients,
   three syncs with ``dcn_compression`` at rank 4 and three of the flat
   ``compress_decompress`` over the four ranks, the codecs' residuals
   carried: per-leaf relative error (of each sync and of the syncs'
   running mean), residual norms, ms; the DCN bytes the recorder saw
   equal to ``dcn_comm_accounting``'s, exactly, beside the flat
   schedule's bytes and each one's seconds at 50 GB/s; (g') the
   Accelerator's PowerSGD step (rank 4) in an NCCL world of one, 4 steps
   at 4 x 2048: losses finite and falling, step ms beside (a)'s;
6f. the Mixtral MoE family (``moe_phase``) at Mixtral 8x7B's widths
   (vocab 32000, hidden 4096, intermediate 14336, 32 q / 8 kv heads of
   128, 8 experts, top 2, capacity factor 1.25), depth cut to 2 layers,
   B 4 x T 1024: the routing of each layer (capacity, dropped share, aux
   and z losses); (f2) the fwd + bwd over a virtual ep 4 world (2 experts
   a rank, the partial outputs summed over ep) against the unsharded fwd +
   bwd: every layer's dispatch masks against the unsharded forward's
   (the first must be bitwise equal), 8 launches each of #1-#3 held to
   their plain versions, the batch-2 rule, each rank's lion-sr update of
   its expert slices bitwise the whole leaf's; (f1) the Accelerator's
   train step with the 600m recipe (bf16, bf16 gradients, lion-sr): 2
   launches each of #1-#3 a step held to their plain versions, step ms,
   tokens/s, MFU on ``count_active_params`` plus attention, peak memory,
   one profiled step;
6g. the two-process serving fabric (``fleet_fabric_phase``): two
   processes of a gloo world (``test_utils/gang.run_gang`` with
   ``device="cuda:0"``; NCCL refuses two ranks on one card, so no NCCL
   collective runs, barriers included) share the H100, each with its
   engine on ``cuda:0`` and the 600m model (random weights from seed 0)
   over int8 pages: rank 0 the prefill role, rank 1 the decode role with
   n-gram speculation at k 2 (``FABRIC_PREFILL`` / ``FABRIC_DECODE``:
   JAX's independent geometries at the serving engine's pages), 8 requests
   of the serving trace at 32-64 new tokens, no EOS, through
   ``test_utils/scripts/fleet_fabric.serve_fabric`` (the header, then the
   ``pps``-wide payload leaf by leaf as raw bytes over gloo): every request
   finishes; bytes sent = received = ``transfer_accounting``, exactly; #7
   once per layer of every prefill step and verify pass and #5 once per
   layer of every plain decode tick, counted per role; rank 1's tokens
   under the token rule against its fused serve of the same trace; one
   checked pass on rank 1 (every #5 / #7 launch against its plain
   version); the resource contract on both roles after every tick; the
   router smoke on rank 0; prints the wire's ms and GB/s a request (host
   copy plus gloo), TTFT and tokens/s beside the in-process int8 pair's,
   and both processes' peak memory;
6h. sharded checkpoints (``sharded_ckpt_phase``): the 600m train state
   (bf16 params, lion-sr momentum) after 2 steps at 4 x 2048 in one
   process (#1-#3 held to plain on the second), saved whole, laid out
   under FULL_SHARD over a virtual world of 4 ranks in this process (each
   rank restored from that checkpoint onto zeroed shards), each rank's
   own save (synchronous; then asynchronous: the four snapshots, then the
   four writes at once, the files equal to the synchronous ones), the
   bytes each rank wrote equal to its ranges without padding, restores
   onto 2 virtual ranks and onto one process (every param and momentum
   element bitwise the plan's layout of the state), ``merge_weights``
   byte for byte ``save_model`` of the params, and one more step on the
   restored process bitwise the step on the state (loss and params, #1-#3
   held to plain); save and restore ms and GB/s per rank;
6i. the sharded step's memory and precision recipes
   (``sharded_recipes_phase``): the 600m at full widths and depth over a
   virtual world of 4, FULL_SHARD, one row of 2048 a rank, bf16
   gradients: (a) ``reshard_after_forward`` True and False and the
   whole-tree step, 2 lion-sr8 steps each (the first counted: 64 launches
   each of #1-#3; the second held to plain), the memory each step adds
   after the forward and at its peak, step ms, all three bitwise; (b)
   ZeRO-offload of each rank's ranges: a monolithic step bitwise the
   resident plan step and a chunked pipelined one, each rank's D2H / H2D
   bytes equal to ``offload_transfer_accounting`` of its ranges, its host
   ms; (c) fp8 under dp 4 and tp 2 x dp_shard 2, one step each beside
   bf16: the metas bitwise equal on every rank, every ``_scaled_mm``
   product of a second step held to plain (1e-3 of each row's largest sum
   of |terms|, its error against the row's largest value reported),
   tokens/s;
6j. tensor-parallel serving and generation (``tp_serving_phase``): the
   600m at full widths and depth, every rank of a virtual tp world bound to
   its slices (``bind_tp_slices``), the collective matmul off, each serve
   the trace's first 2 requests at its 32-128 new tokens: (a) bf16 pages
   at tp 2 and tp 4; (b) int8 weights (embedding, norms, ``lm_head``
   skipped) over int8 pages, tp 2, the W8A16 route each rank's dense took
   printed; (c) the 8-tenant LoRA trace (rank-16 q / v, pool 4), tp 2,
   every rank's store swapping as the one-process store; (d) ``generate`` at B 4 x
   prompt 128, 32 new tokens, and ``beam_search`` with 4 beams, 8 new
   tokens, bf16 and int8, tp 2 (int8 ``generate`` again at 4 new tokens
   with every #11 / #12 launch held to plain); (e) one fwd + bwd of the
   scanned stack at 4 x 2048 under tp 2 against the one-process scanned
   step (the batch-2 rule), then with every #1-#3 launch held to plain.
   Each serve: launches as the path says, a rank's KV pool ``kv_heads /
   Hkv`` of the one-process pool (1 / tp where tp divides them), a rank's
   weight bytes equal to ``plan_bytes_per_device``, tokens equal to the
   one-process serve's or first different at a near-tie (teacher-forced
   through both), TTFT p50 and tokens/s beside the one-process serve's; a
   checked rerun of its requests, until one of them wrote into a page past
   its prompt's, with every launch held to plain, the serving
   contract on every rank after every tick and every rank's block tables
   and event log equal to rank 0's;
7. prints the kernels' JSON line (all twelve kernels; #8 / #9 with the
   launches of the op phase, since no engine calls them; ``paths``: each
   kernel's launches on the speculative, draft-model, prefix-cache, int8
   prefix-cache, overload, pair (bf16, int8) and fleet serves, the loaded
   serves (``big_model_serve``, ``big_model_serve_int8``), the int8
   streamed decode (``streamed``) and beam search (``beam``) and, for
   #1-#3, the ``train_resume`` runs, the ``memory_*`` runs of step 6b,
   the ``lora_train`` steps of step 6c, the recovery ladder's steps
   (``train_resume_ladder``), the ``parallel`` ring pass, Ulysses pass,
   tp steps, pipelined step, (g)'s rank passes (``parallel_dcn``) and
   PowerSGD steps (``parallel_powersgd``) of step 6e, the ``moe``
   step and ep pass of step 6f, the fabric's roles of step 6g
   (``fleet_fabric_prefill``, ``fleet_fabric_decode``) and the first
   step of 6h (``sharded_ckpt``), 6i's first per-unit step
   (``sharded_recipes``) and its bf16 / fp8 steps
   (``sharded_recipes_{bf16,fp8}_{dp4,tp2_dp2}``), 6j's serves
   (``tp_serving_{bf16_tp2,bf16_tp4,int8_tp2,lora_tp2}``), generation
   (``tp_serving_{generate,beam}_{bf16,int8}_tp2``) and scanned step
   (``tp_serving_scan_tp2``); #1-#3's ``cases`` and ``f16`` hold their f16
   instances, ``lora_train_in_path`` their checked LoRA step,
   ``tp_serving_in_path`` each kernel's checked launches in 6j), then
   ``{"ok": true,
   "device": {...}}`` as the last line.

``profile_serving.py`` profiles a window of the same engine's ticks.

Any failed phase raises: the script exits non-zero and prints no result.
It exits non-zero at once where there is no CUDA device, or where it is
not inside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, NVIDIA data sheet
# a kernel's output row (one token of one slot, over heads and head dim)
# passes iff max|out - ref| <= KERNEL_TOL * min(1, max|ref row|): 2e-2 on rows
# of O(1), scaled down with rows that average a deep window.  A row's scale
# is floored at ROW_SCALE_FLOOR * min(1, max|ref|) over the whole output, so
# an all-zero row's limit stays above 0 and the limit of a tensor whose every
# value is small (the gradients of a random model) scales down with it.  The
# worst error over a whole output must also stay within KERNEL_TOL of the
# output's largest |ref|.  Kernel #10's outputs (LoRA deltas) are not O(1):
# there each element may also be off by half a bf16 step of its |ref|, the
# output's one rounding (``held_to_plain(slack=half_ulp_bf16(ref))``), and
# its fused output (y + delta, two roundings) by half a step of the delta
# and half a step of the sum (``lora_plain``)
KERNEL_TOL = 2e-2
ROW_SCALE_FLOOR = 1e-3
# #1-#3's f16 instances: an f16 step is 2^-3 of a bf16 step, so the limit is
# KERNEL_TOL / 8 and the slack half an f16 step.  The floored rows' limit
# (KERNEL_TOL * ROW_SCALE_FLOOR of the tensor's scale) stays as it is: it
# holds rows that cancel to ~0 (a causal first row's dq), whose error is
# the f32 sums' order on terms of O(1), the same in either type
KERNEL_TOL_F16 = KERNEL_TOL / 8
ROW_SCALE_FLOOR_F16 = ROW_SCALE_FLOOR * 8

# the 600m serving model and its engine geometry
MODEL = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
             num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=8,
             max_position_embeddings=4096, attn_implementation="flash")
PLUGIN = dict(num_slots=16, page_size=64, pages_per_slot=32, num_pages=256,
              prefill_chunk=512)
# bench.py --serve's trace with each request's new tokens cut from 32-256
# to 32-128: the serves are host-bound, and the script must fit its time
# limit on a slow host.  The overload storm keeps 32-256 (OVERLOAD_NEW):
# its cancel and deadline events fire up to serve step 276
TRACE = dict(vocab_size=32000, mean_interarrival_steps=0.5,
             prompt_len_range=(64, 512), new_tokens_range=(32, 128))
MAX_NEW = 128
OVERLOAD_NEW = (32, 256)
N_REQUESTS = 16
# the depth of every checked rerun (each kernel launch held against its
# plain version): each request's new tokens capped here, the timed serves
# keeping the trace's 32-256; and generate_paged's checked rerun's new
# tokens.  Cut so the script, whose serves are host-bound, fits its time
# limit on a slow host
CHECKED_NEW = 64
GEN_CHECKED_NEW = 16
# the 16 decode slots' positions of the paged decode cases: 0, page edges and
# 2047, the block table's last token
DEC_POS = [0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1024, 1500, 2000, 2046, 2047]

# quantized serving: int8 weights and int8 pages on the same engine and
# trace; generate_paged at batch 4 with fp8 pages
QUANT_KV = "int8"
# the quantized serve again over pages of 32 tokens (the same tokens per
# slot and in the pool) under decode_kernel="auto", on the trace's first 8
# requests
PAGES_32 = dict(PLUGIN, page_size=32, pages_per_slot=2 * PLUGIN["pages_per_slot"],
                num_pages=2 * PLUGIN["num_pages"], decode_kernel="auto")
PAGES_32_REQUESTS = 8
GEN_PAGED = dict(batch=4, prompt_len_range=(128, 256), max_new=32, kv_dtype="fp8")
GEN_T = 250           # the prefill window of kernel #7's case at generate_paged's geometry
# #4 / #5 at generate_paged's geometry: 4 slots over pages of 16 mid-decode,
# on both sides of the 256-token chunk edge (255 ends the first chunk, 256
# leaves one live key in the second)
GEN_DEC_POS = [130, 255, 256, 313]
# the 600m model's denses (H -> F) and an H with a partial 64-row K tile
QMM_SHAPES = {"q_proj / o_proj": (1536, 1536), "k_proj / v_proj": (1536, 768),
              "gate_proj / up_proj": (1536, 4096), "down_proj": (4096, 1536),
              "masked_k_tail": (1576, 768)}
# #11 at the decode step (16), the plan switch (64 / 65) and a prefill chunk (512)
QMM_M = {"quantized_matmul_tiled": (16, 64, 65, 512), "quantized_matmul_wholef": (1, 4, 8)}
QMM_MAIN = {"quantized_matmul_tiled": ("gate_proj / up_proj", 16),       # the decode step
            "quantized_matmul_wholef": ("gate_proj / up_proj", 4)}     # generate_paged's
REPLACES = {"paged_decode_attention": "accelerate_tpu/ops/flash_attention.py:589",
            "paged_multitoken_attention": "accelerate_tpu/ops/flash_attention.py:809",
            "paged_decode_attention_quant": "accelerate_tpu/ops/flash_attention.py:604",
            "paged_multitoken_attention_quant": "accelerate_tpu/ops/flash_attention.py:818",
            "quantized_matmul_tiled": "accelerate_tpu/ops/quantized_matmul.py:59",
            "quantized_matmul_wholef": "accelerate_tpu/ops/quantized_matmul.py:101"}

# multi-tenant LoRA serving: bench.py --serve --adapters 8 (bench.py:500-537)
LORA = dict(rank=16, pool_slots=4, targets=("q_proj", "v_proj"), kernel="auto")
LORA_TENANTS = 8
# one adapter: 16 layers x (q 1536x16 + 16x1536, v 1536x16 + 16x768) bf16
LORA_ADAPTER_BYTES = 16 * (1536 * 16 + 16 * 1536 + 1536 * 16 + 16 * 768) * 2
LORA_IDS = [0, 1, 2, 1, 3, 0, 4, 4, 2, 0, 1, 3, 3, 4, 0, 2]   # 16 slots, ids 0..4
LORA_SHAPES = {"q_proj": (1536, 1536), "v_proj": (1536, 768)}
LORA_TICKS = 24       # decode ticks before the fused op takes the engine's operands
LORA_REPLACES = {"bgmv_apply": "accelerate_tpu/ops/lora.py:177",
                 "fused_bgmv_paged_decode": "accelerate_tpu/ops/flash_attention.py:988",
                 "fused_bgmv_paged_decode_quant": "accelerate_tpu/ops/flash_attention.py:999"}

# speculative decode: bench.py --serve --speculate 4 (prompt lookup, k 4, one
# verify bucket); when the seeded trace accepts no draft, CYCLE_REQUESTS
# prompts that repeat a CYCLE-token cycle; a draft-model serve of
# DRAFT_REQUESTS requests, DRAFT_NEW tokens each, through a DRAFT_LAYERS-layer
# model at the 600m widths (kernel #1 at T = its window of 32)
SPEC = dict(speculate="ngram", speculate_k=4)
CYCLE, CYCLE_REQUESTS = 5, 8
DRAFT_REQUESTS, DRAFT_NEW, DRAFT_LAYERS = 4, 32, 2
# the prefix cache: bench.py --serve --prefix-share 0.5, served with both
# features off, then with the prefix cache and speculation on; the int8
# model from int8 pages on the trace's first PREFIX_QUANT_REQUESTS requests
PREFIX_SHARE = 0.5
PREFIX_QUANT_REQUESTS = 4
# each new path's kernel-wrapper launches, counts zeroed just before it
PATH_LAUNCHES: dict = {}
# the in-process pairs' reports, printed beside the two-process fabric's
PAIR_REPORTS: dict = {}
# overload: 32 requests of the bench trace through the speculative bf16
# engine with a bounded queue, a KV-pressure watermark and a default
# deadline, under a seeded cancel / deadline storm (FaultPlan.from_seed); the
# operator escalates the ladder at LADDER_TICKS and the storm's deadline
# event takes it to its fourth stage
OVERLOAD_REQUESTS = 32
OVERLOAD = dict(max_queue=10, kv_shed_watermark=0.95, default_deadline_ticks=400)
STORM = dict(seed=45, n_steps=320, p_cancel=0.012, p_deadline=0.004)
LADDER_TICKS = (24, 48, 72)
# the disaggregated pair: the bf16 trace, and its first PAIR_INT8_REQUESTS
# requests with int8 weights and int8 pages
PAIR_INT8_REQUESTS = 4
# the fleet: two fused bf16 engines over one model, the prefix-share trace,
# a replica_kill at fleet tick FLEET_KILL_AT
FLEET_REPLICAS, FLEET_KILL_AT = 2, 40

# the 600m training step (bench.py's headline configuration on one chip)
TRAIN = dict(batch=10, seq=2048, warmup=2, timed=10, ce_chunks=4, optimizer="lion-sr")
CHECK_BATCH = 2       # the batch of the six-case kernel checks and the step comparison
LOSS_RTOL = 1e-3      # kernels vs plain versions, one step at CHECK_BATCH
GNORM_RTOL = 2e-2
LEAF_RTOL = 5e-2      # per leaf: ||g_kernel - g_plain|| / ||g_plain||


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def sync(torch):
    """Wait for the card, where there is one (the CPU rehearsal has none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


_CAPTURE: dict = {}     # the one stream every graph of time_ms is captured on


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, CUDA events.
    With ``graph`` the ``iters`` calls are captured in one CUDA graph and
    the graph is timed: a kernel of a few microseconds then reads its own
    time, not the rate at which the host launches it.  The warm-up runs on
    the capture stream, so what a kernel keeps per stream (#4 / #5's merge
    counters) exists before the capture."""
    if graph and "stream" not in _CAPTURE:
        _CAPTURE["stream"] = torch.cuda.Stream()
    side = _CAPTURE["stream"] if graph else torch.cuda.current_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for i in range(iters):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for i in range(iters):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def live_kv_bytes(torch, bt, last_pos, pages, quant: bool) -> tuple[int, int]:
    """The distinct pages and the K + V bytes a paged attention call must
    read at least: slot s reaches keys 0 .. min(last_pos[s], n * page - 1),
    key i at row i % page of page bt[s, i // page]; each distinct (page,
    row) is read once for K and once for V in every kv head, and each
    distinct page's K and V scales (f32 per kv head) when ``quant``."""
    hkv, _, page, d = pages.shape
    n = bt.shape[1]
    keys = torch.arange(n * page, device=bt.device)
    live = keys[None, :] <= last_pos.long()[:, None]                     # [S, n * page]
    rows = (bt.long()[:, keys // page] * page + keys % page)[live]
    pages_read = int(torch.unique(rows // page).numel())
    rows_read = int(torch.unique(rows).numel())
    nbytes = 2 * hkv * (rows_read * d * pages.element_size() + (pages_read * 4 if quant else 0))
    return pages_read, nbytes


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the earlier designs of #2 / #3, #4 / #5, #10 and #12 (--before) ---------

# filled by main() from ``--before DIR``: name -> a callable with the
# kernel wrapper's arguments that launches the earlier design
BEFORE: dict = {}
BEFORE_SOURCES = ("flash_attention", "paged_attention", "quantized_matmul", "lora")


def before_sources(path: Path) -> list:
    """``BEFORE_SOURCES`` as DIR has them: where DIR has no
    ``paged_attention.cu`` (#8 / #9 live in ``paged_decode.cu`` there),
    its ``paged_decode.cu`` in its place."""
    csrc = path / "accelerate_tpu_torch" / "csrc"
    return [name if name != "paged_attention" or (csrc / f"{name}.cu").is_file()
            else "paged_decode" for name in BEFORE_SOURCES]


def start_before_build(path: Path) -> dict:
    """Start nvcc on ``DIR/accelerate_tpu_torch/csrc/<name>.cu`` for each
    of :func:`before_sources` (their headers beside them) into
    ``build/before/``, with the port's flags, all at once.  Returns, by
    name, the process and the library's path."""
    from accelerate_tpu_torch.ops import _build

    out = ROOT / "build" / "before"
    out.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in before_sources(path):
        src = path / "accelerate_tpu_torch" / "csrc" / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"--before: {src} is not there")
        lib = out / f"lib{name}.so"
        started[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return started


def before_function(path: Path, name: str):
    """The module-level function ``name`` of the Python source ``path``,
    with the module's constant assignments it may read (the file is not
    imported: its package is another checkout's)."""
    import ast

    tree = ast.parse(path.read_text())

    def constant(node) -> bool:      # NAME[, NAME...] = literal[, literal...]
        return (isinstance(node, ast.Assign)
                and all(isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets)
                and all(isinstance(v, (ast.Constant, ast.Tuple, ast.expr_context))
                        for v in ast.walk(node.value)))

    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name == name) or constant(node)]
    namespace: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), namespace)
    return namespace.get(name)


def before_kernels(torch, builds: dict, path: Path) -> dict:
    """Bind the earlier designs built by :func:`start_before_build`, called
    as their wrappers call them: #2 and #3 (``flash_attention_dq_bf16`` and
    ``flash_attention_dkv_bf16`` of the earlier ``flash_attention.cu``),
    #12 (the earlier ``qmm_wholef``: two launches, on the earlier
    ``wholef_splits``), #10 (the earlier ``bgmv_bf16`` with the three
    elementwise launches of the select around it), and :func:`before_paged`'s
    #8 / #9 and #4 / #5."""
    libs = {}
    for name, (proc, lib) in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"--before: nvcc failed on {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    fl = libs["flash_attention"]
    P, I = ctypes.c_void_p, ctypes.c_int
    fl.flash_attention_dq_bf16.argtypes = [I] + [P] * 11 + [I] * 7 + [ctypes.c_float, P]
    fl.flash_attention_dq_bf16.restype = I
    fl.flash_attention_dkv_bf16.argtypes = [I] + [P] * 12 + [I] * 7 + [ctypes.c_float, P]
    fl.flash_attention_dkv_bf16.restype = I

    def launch(fn, label, q, k, v, own, causal, sm_scale):
        b, t, h, d = q.shape
        s, hkv = k.shape[1], k.shape[2]
        err = fn(q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                 None, None, *[x.data_ptr() for x in own], b, t, s, h, hkv, d, int(causal),
                 float(sm_scale), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"--before: {label} launch failed ({err})")

    def flash_dq(q, k, v, g, lse, delta, *, causal, sm_scale):
        dq = torch.empty_like(q)
        launch(fl.flash_attention_dq_bf16, "#2", q, k, v, [g, lse, delta, dq], causal, sm_scale)
        return dq

    def flash_dkv(q, k, v, g, lse, delta, *, causal, sm_scale):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        launch(fl.flash_attention_dkv_bf16, "#3", q, k, v, [g, lse, delta, dk, dv], causal,
               sm_scale)
        return dk, dv

    kernels = {"flash_dq": flash_dq, "flash_dkv": flash_dkv}
    kernels.update(before_w8a16_lora(torch, libs, path))
    kernels.update(before_paged(torch, libs))
    return kernels


def before_paged(torch, libs: dict) -> dict:
    """DIR's #8 / #9 and, where its ``paged_attention.cu`` still has them,
    its #4 / #5, called as their wrappers call them.  From a
    ``paged_attention.cu``: the first decode design (one block per (slot,
    kv head), pages in turn); from a ``paged_decode.cu``: the split page
    loop, launched on this tree's ``fused_decode_plan`` and merge counters."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    P, I = ctypes.c_void_p, ctypes.c_int
    suffixes = ("bf16", "int8", "fp8")
    suffix_of = lambda k_pages, k_scales: (
        "bf16" if k_scales is None else "int8" if k_pages.dtype == torch.int8 else "fp8")
    split = "paged_attention" not in libs
    lib = libs["paged_decode" if split else "paged_attention"]
    for suffix in suffixes:
        fn = getattr(lib, f"fused_bgmv_paged_decode_{suffix}")
        fn.argtypes = ([I] + [P] * 16 + [I] * 14 if split else [I] + [P] * 14 + [I] * 11) + [
            ctypes.c_float, P]
        fn.restype = I

    def fused(x, q_base, a_stack, b_stack, adapter_ids, cos, sin, k_pages, v_pages,
              block_tables, positions, *, k_scales=None, v_scales=None):
        out = torch.empty_like(q_base)
        s_slots, h, d = q_base.shape
        hkv, num_pages, page, _ = k_pages.shape
        n = block_tables.shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        plan = []
        if split:
            pl = fa.fused_decode_plan(s_slots, h, hkv, d, page, n)
            work = counters = None
            if pl["chunks"] > 1:
                work = torch.empty(pl["workspace"], dtype=torch.float32, device=q_base.device)
                counters = fa._decode_counters(q_base.device, stream, pl["counters"])
            plan = [None if work is None else work.data_ptr(),
                    None if counters is None else counters.data_ptr()]
        sizes = [s_slots, h, hkv, d, num_pages, page, n]
        if split:
            sizes += [pl["span"], pl["rows"], pl["cluster"]]
        suffix = suffix_of(k_pages, k_scales)
        err = getattr(lib, f"fused_bgmv_paged_decode_{suffix}")(
            q_base.device.index or 0, q_base.data_ptr(), x.data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), adapter_ids.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(), block_tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), *plan, *sizes, x.shape[1], a_stack.shape[2],
            a_stack.shape[0], cos.shape[0], d ** -0.5, stream)
        if err:
            raise RuntimeError(f"--before: fused_bgmv_paged_decode_{suffix} launch failed ({err})")
        return out

    kernels = {"fused_bgmv_paged_decode": fused, "fused_bgmv_paged_decode_quant": fused}
    # the earlier decode entry points, where DIR's paged_attention.cu still
    # has them: device, q, k_pages, v_pages, [k_scales, v_scales,]
    # block_tables, positions, out, S T H Hkv D P page n, sm_scale, stream
    if split or not hasattr(lib, "paged_decode_attention_bf16"):
        log("--before: DIR has no paged_decode_attention_* in a paged_attention.cu (#4 / #5 "
            "live in paged_decode.cu there): no earlier #4 / #5 to time")
        return kernels
    for suffix, scales in zip(suffixes, (0, 2, 2)):
        fn = getattr(lib, f"paged_decode_attention_{suffix}")
        fn.argtypes = [I] + [P] * (6 + scales) + [I] * 8 + [ctypes.c_float, P]
        fn.restype = I

    def paged_decode(q, k_pages, v_pages, block_tables, positions, *, k_scales=None,
                     v_scales=None):
        out = torch.empty_like(q)
        hkv, num_pages, page, d = k_pages.shape
        scales = [k_scales.data_ptr(), v_scales.data_ptr()] if k_scales is not None else []
        suffix = suffix_of(k_pages, k_scales)
        err = getattr(lib, f"paged_decode_attention_{suffix}")(
            q.device.index or 0, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(), q.shape[0], 1,
            q.shape[1], hkv, d, num_pages, page, block_tables.shape[1], d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"--before: paged_decode_attention_{suffix} launch failed ({err})")
        return out

    return {**kernels, "paged_decode_attention": paged_decode,
            "paged_decode_attention_quant": paged_decode}


def before_w8a16_lora(torch, libs: dict, path: Path) -> dict:
    """#10's earlier route (DIR's ``bgmv_bf16``, then the id test, the add
    and the select: four launches) and, where DIR has it, #12's earlier
    design (``qmm_wholef`` with an f32 scratch and a second launch that
    adds the slices, split by DIR's ``wholef_splits``)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lo = libs["lora"]
    lo.bgmv_bf16.argtypes = [I] + [P] * 5 + [I] * 5 + [P]
    lo.bgmv_bf16.restype = I

    def bgmv_apply(x, y, a_stack, b_stack, ids):
        delta = torch.empty(x.shape[0], b_stack.shape[2], dtype=x.dtype, device=x.device)
        err = lo.bgmv_bf16(x.device.index or 0, x.data_ptr(), a_stack.data_ptr(),
                           b_stack.data_ptr(), ids.data_ptr(), delta.data_ptr(), x.shape[0],
                           x.shape[1], a_stack.shape[2], b_stack.shape[2], a_stack.shape[0],
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"--before: bgmv_bf16 launch failed ({err})")
        return torch.where((ids > 0)[:, None], y + delta, y)

    kernels = {"bgmv_apply": bgmv_apply}
    splits_of = before_function(path / "accelerate_tpu_torch" / "ops" / "quantized_matmul.py",
                                "wholef_splits")
    if splits_of is None:
        log("--before: DIR's quantized_matmul.py has no wholef_splits (its #12 is this "
            "design): no earlier #12 to time")
        return kernels
    qm = libs["quantized_matmul"]
    qm.qmm_wholef.argtypes = [I] + [P] * 5 + [I] * 6 + [P]
    qm.qmm_wholef.restype = I

    def wholef(x, codes, scales, *, qblock, out_dtype=None):
        out_dtype = out_dtype or x.dtype
        m, h = x.shape
        f = codes.shape[1]
        splits = splits_of(m, h, f)
        out = torch.empty(m, f, dtype=out_dtype, device=x.device)
        partial = (torch.empty(splits, m, f, dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = qm.qmm_wholef(x.device.index or 0, x.data_ptr(), codes.data_ptr(),
                            scales.data_ptr(), out.data_ptr(),
                            None if partial is None else partial.data_ptr(), m, h, f, qblock,
                            splits, int(out_dtype == torch.float32),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"--before: qmm_wholef launch failed ({err})")
        return out

    kernels["quantized_matmul_wholef"] = wholef
    return kernels


def paged_case(torch, *, slots, width, pos0, copies=4, seed=0, kv_dtype=None, device="cuda",
               page=None, n=None):
    """Random bf16 operands at the 600m paged-attention geometry.  Each
    slot's live block-table entries name distinct pages, drawn without
    replacement from the pool as the engine's allocator hands them out;
    entries past a slot's last live page stay 0, as in a fresh cache.
    Several copies of the page pool rotate between timed launches, so each
    launch finds its pages out of the 50 MB L2 as a layer of the real model
    does.  With ``kv_dtype`` ``"int8"`` / ``"fp8"`` each pool holds codes
    written through ``paged_write_kv_quantized``, so each page's scale is
    its rows' amax: a pool is then ``(k_pages, v_pages, k_scales,
    v_scales)``.  ``page`` / ``n`` override the engine's page size and
    pages per slot (``generate_paged`` provisions pages of 16)."""
    from accelerate_tpu_torch.models.llama import KV_QUANT_DTYPES, paged_write_kv_quantized

    hkv, h = MODEL["num_key_value_heads"], MODEL["num_attention_heads"]
    d = MODEL["hidden_size"] // h
    page, n = page or PLUGIN["page_size"], n or PLUGIN["pages_per_slot"]
    num_pages = max(PLUGIN["num_pages"], slots * n)
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = device

    def pool():
        k, v = (torch.randn(hkv, num_pages, page, d, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        if kv_dtype is None:
            return k, v
        ids = torch.arange(num_pages, device=dev)[:, None].expand(num_pages, page)
        offs = torch.arange(page, device=dev)[None].expand(num_pages, page)
        out = []
        for vals in (k, v):
            pages = torch.zeros(vals.shape, dtype=KV_QUANT_DTYPES[kv_dtype], device=dev)
            scales = torch.zeros(hkv, num_pages, device=dev)
            paged_write_kv_quantized(pages, scales, vals.permute(1, 2, 0, 3), ids, offs, kv_dtype)
            out.append((pages, scales))
        return out[0][0], out[1][0], out[0][1], out[1][1]

    pools = [pool() for _ in range(copies)]
    live = [min((p + width - 1) // page, n - 1) + 1 for p in pos0]
    if sum(live) > num_pages:
        raise ValueError(f"{sum(live)} live pages do not fit a pool of {num_pages}")
    ids = torch.randperm(num_pages, generator=torch.Generator().manual_seed(seed))
    bt = torch.zeros(slots, n, dtype=torch.int32)
    start = 0
    for s, count in enumerate(live):
        bt[s, :count] = ids[start:start + count]
        start += count
    bt = bt.to(dev)
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=dev)
    positions = (pos0[:, None] + torch.arange(width, device=dev, dtype=torch.int32)).contiguous()
    q = torch.randn(slots, width, h, d, generator=gen, device=dev).bfloat16()
    return dict(q=q, pools=pools, bt=bt, positions=positions, hkv=hkv, h=h, d=d,
                page=page, n=n, kv_dtype=kv_dtype)


def half_ulp_bf16(torch, ref):
    """Half a bf16 step at each |ref|: what one rounding of an exact value
    to bf16 may move it (0 at 0)."""
    mag = ref.float().abs()
    _, exp = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), exp - 9),
                       torch.zeros_like(mag))


def half_ulp_f16(torch, ref):
    """Half an f16 step at each |ref| (f16's subnormal step below 2^-14)."""
    mag = ref.float().abs()
    _, exp = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), (exp - 12).clamp(min=-25)),
                       torch.zeros_like(mag))


def held_to_plain(torch, name, out, ref, slack=None, tol=KERNEL_TOL,
                  row_floor=ROW_SCALE_FLOOR) -> dict:
    """A kernel's ``out`` against ``ref``, its plain version in f32 on the
    same bf16 operands, row by row (see ``KERNEL_TOL``; an f16 instance
    passes ``KERNEL_TOL_F16`` and ``ROW_SCALE_FLOOR_F16``).  With ``slack``
    (a tensor like ``ref``) each element may also be off by that much: the
    roundings of a bf16 output that leaves O(1) (at |ref| >= 8 half a bf16
    step is above KERNEL_TOL).  Returns the readings; raises if a row fails
    or ``out`` is not finite."""
    width = out.shape[-2] * out.shape[-1]
    err = (out.float() - ref.float()).abs()
    if slack is not None:
        err = (err - slack).clamp(min=0)
    diff = err.reshape(-1, width).amax(dim=1)
    scale = ref.float().reshape(-1, width).abs().amax(dim=1)
    floor = row_floor * scale.max().clamp(max=1.0).item()
    ratio = diff / (tol * scale.clamp(min=max(floor, 1e-30), max=1.0))
    worst = int(ratio.argmax())
    rep = {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "err_over_limit": ratio.max().item(),
           "worst_row_err": diff[worst].item(), "worst_row_ref_max": scale[worst].item(),
           "min_row_ref_max": scale.min().item(), "tensor_ref_max": scale.max().item(),
           "err_over_tensor_max": (diff.max() / scale.max().clamp(min=1e-30)).item()}
    if not (bool(torch.isfinite(out).all()) and rep["err_over_limit"] <= 1.0
            and rep["err_over_tensor_max"] <= tol):
        raise AssertionError(f"{name}: output off its plain version: {rep}")
    return rep


def lora_plain(torch, lora_mod, x, y, a_stack, b_stack, ids):
    """#10's fused plain version in f32 on the kernel's bf16 operands,
    ``where(ids > 0, y + delta, y)`` with the f32 delta of ``bgmv_plain``,
    and the slack of the kernel's two roundings (the delta's and the
    sum's, half a bf16 step each; none on the rows it copies)."""
    delta = lora_mod.bgmv_plain(x.float(), a_stack, b_stack, ids)
    live = (ids > 0)[:, None]
    ref = torch.where(live, y.float() + delta, y.float())
    slack = torch.where(live, half_ulp_bf16(torch, delta) + half_ulp_bf16(torch, ref),
                        torch.zeros_like(ref))
    return ref, slack


def _pool_args(pool):
    """``(k_pages, v_pages)`` and the scale keywords of a case's pool."""
    kw = dict(k_scales=pool[2], v_scales=pool[3]) if len(pool) == 4 else {}
    return pool[:2], kw


def case_report(torch, F, fa, case, decode: bool) -> dict:
    q, pools, bt, positions = case["q"], case["pools"], case["bt"], case["positions"]
    slots, width, h, d = q.shape
    hkv, page, n = case["hkv"], case["page"], case["n"]
    (kp, vp), kw = _pool_args(pools[0])
    quant = bool(kw)
    if decode:
        qk, pk = q[:, 0].contiguous(), positions[:, 0].contiguous()
        kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_plain
    else:
        qk, pk = q, positions
        kernel, plain = fa.paged_multitoken_attention, fa.paged_multitoken_attention_plain
    name = kernel.__name__ + ("_quant" if quant else "")
    out = kernel(qk, kp, vp, bt, pk, **kw)
    sync(torch)
    ref = plain(qk.float(), kp if quant else kp.float(), vp if quant else vp.float(), bt, pk, **kw)
    held = held_to_plain(torch, name, out, ref)

    def rotating(fn):
        def call(i):
            pages, pkw = _pool_args(pools[i % len(pools)])
            return fn(qk, *pages, bt, pk, **pkw)
        return call

    ms = time_ms(torch, rotating(kernel), graph=True)
    plain_ms = time_ms(torch, rotating(plain), iters=5)
    # #4 / #5's earlier design (--before): held to the plain version and
    # timed the same way
    before = {}
    if decode and name in BEFORE:
        early = BEFORE[name](qk, kp, vp, bt, pk, **kw)
        sync(torch)
        before["before_err_over_limit"] = held_to_plain(
            torch, f"{name} (earlier design)", early, ref)["err_over_limit"]
        before["before_ms"] = time_ms(torch, rotating(BEFORE[name]), graph=True)
        del early

    # yardstick: one SDPA call over the gathered KV (dequantized to bf16 for
    # quantized pages), GQA heads repeated and the positional mask given as
    # a boolean mask (set-up not timed)
    from accelerate_tpu_torch.models.llama import paged_gather_kv

    kv_len = n * page
    k_lin, v_lin, _ = paged_gather_kv(kp, vp, bt, kw.get("k_scales"), kw.get("v_scales"),
                                      torch.bfloat16)
    k_lin = k_lin.permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1).contiguous()
    v_lin = v_lin.permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1).contiguous()
    q_lin = q.permute(0, 2, 1, 3).contiguous()                       # [S, H, T, D]
    mask = (torch.arange(kv_len, device=q.device)[None, None, None, :]
            <= positions[:, None, :, None])                          # [S, 1, T, L]
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q_lin, k_lin, v_lin, attn_mask=mask), graph=True)

    # least time for this data: q/out/tables read or written once, each
    # distinct live row (page, row) the slots' keys reach read once for K
    # and for V in every kv head, and each distinct page's f32 scales when
    # quantized; 4 flops per (q row, head dim, live key)
    pages_read, kv_bytes = live_kv_bytes(torch, bt, positions[:, -1], kp, quant)
    nbytes = 2 * q.numel() * 2 + bt.numel() * 4 + positions.numel() * 4 + kv_bytes
    flops = 4 * h * d * int((positions.long() + 1).sum())
    bound_ms, bound_by = bound(nbytes, flops)
    return {**held, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **before,
            "shape": {"slots": slots, "width": width, "heads": h, "kv_heads": hkv,
                      "head_dim": d, "page": page, "pages_per_slot": n,
                      "pages_read": pages_read, "kv_dtype": case["kv_dtype"] or "bf16",
                      "pos0": [int(x) for x in positions[:, 0].tolist()]}}


CASE_KEYS = ("shape", "max_abs_err", "err_over_limit", "worst_row_err", "worst_row_ref_max",
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "before_ms", "delta_ms",
             "four_launch_ms", "composed_ms", "bitwise")


def _with_cases(cases: list, main: dict) -> dict:
    """``main``'s readings, the worst error over every case, and the cases."""
    rep = dict(main)
    rep["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    rep["err_over_limit"] = max(c["err_over_limit"] for c in cases)
    rep["cases"] = [{k: c[k] for k in CASE_KEYS if k in c} for c in cases]
    return rep


# #4 / #5's decode cases: the serve's 16 slots over pages of 64 (the main
# path's shape), the same tokens over the quantized serve's pages of 32, and
# generate_paged's 4 slots over pages of 16
DEC_CASES = (dict(slots=16, pos0=DEC_POS),
             dict(slots=16, pos0=DEC_POS, page=PAGES_32["page_size"],
                  n=PAGES_32["pages_per_slot"]),
             dict(slots=GEN_PAGED["batch"], pos0=GEN_DEC_POS, page=16,
                  n=-(-(GEN_T + GEN_PAGED["max_new"]) // 16)))
# filled by main(): ptxas's registers and spilled bytes of each #4 / #5
# instance and of each #8 / #9 instance
DECODE_PTXAS: dict = {}
FUSED_PTXAS: dict = {}


def decode_ptxas(ptxas: str) -> tuple[dict, dict]:
    """ptxas's registers and spilled bytes of each instance of
    ``paged_decode.cu``'s kernel in its build log, by page kind, head dim
    and query rows a block: #4 / #5's instances, then #8 / #9's (the
    template's LoRA query)."""
    kinds = {"Bf16Pages": "bf16", "Int8Codes": "int8", "Fp8Codes": "fp8"}

    def instance(name):
        k = re.search(r"(Bf16Pages|Int8Codes|Fp8Codes)\S*?Li(\d+)ELi(\d+)ELb([01])E", name)
        return (("fused " if k.group(4) == "1" else "")
                + f"{kinds[k.group(1)]} D{k.group(2)} rows {k.group(3)}")

    every = kernel_ptxas(ptxas, "paged_decode_kernel", instance)
    return ({k: v for k, v in every.items() if not k.startswith("fused ")},
            {k[len("fused "):]: v for k, v in every.items() if k.startswith("fused ")})


def decode_loop_spills(lib: Path, ptxas: dict, fused: dict) -> None:
    """Add to each spilling instance of ``paged_decode.cu``'s kernel (the
    records of :func:`decode_ptxas`) the local-memory loads and stores its
    SASS has inside the page loop, between its first and last ``HMMA``
    (``cuobjdump -sass`` of the library)."""
    from accelerate_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        log(f"no {cuobjdump}: the page loop's spills are not counted")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    kinds = {"Bf16Pages": "bf16", "Int8Codes": "int8", "Fp8Codes": "fp8"}
    for block in sass.split("Function : ")[1:]:
        k = re.search(r"paged_decode_kernel\S*?(Bf16Pages|Int8Codes|Fp8Codes)\S*?Li(\d+)ELi(\d+)"
                      r"ELb([01])E", block.split()[0])
        if not k:
            continue
        rec = (fused if k.group(4) == "1" else ptxas).get(
            f"{kinds[k.group(1)]} D{k.group(2)} rows {k.group(3)}")
        if not rec or not rec.get("spill_bytes"):
            continue
        ops = re.findall(r"\b(HMMA|LDL|STL)\b", block)
        mma = [i for i, op in enumerate(ops) if op == "HMMA"]
        rec["loop_spill_instructions"] = sum(
            1 for i, op in enumerate(ops) if op != "HMMA" and mma and mma[0] < i < mma[-1])


def kernel_ptxas(ptxas: str, kernel: str, instance) -> dict:
    """ptxas's registers and spilled bytes of each instance of ``kernel`` in
    a build log, keyed by ``instance(mangled name)``."""
    out, current = {}, None
    for line in ptxas.splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            current = (out.setdefault(instance(m.group(1)), {}) if kernel in m.group(1)
                       else None)
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def two_streams_bitwise(torch, calls) -> int:
    """Each of ``calls`` once on the current stream, then ``REPEATS`` times
    on a stream of its own, the streams launching at once: every launch
    bitwise equal to its call's first.  Returns the launches checked."""
    refs = [call() for call in calls]
    streams = [torch.cuda.Stream() for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[] for _ in calls]
    for _ in range(REPEATS):
        for j, (call, st) in enumerate(zip(calls, streams)):
            with torch.cuda.stream(st):
                outs[j].append(call())
    sync(torch)
    for j, runs in enumerate(outs):
        for i, out in enumerate(runs):
            if not torch.equal(out, refs[j]):
                raise AssertionError(f"launch {i + 1} on stream {j} differs from the same call "
                                     "alone")
    return sum(len(runs) for runs in outs)


def decode_bitwise(torch, fa, case) -> dict:
    """#4 / #5 on ``case``'s operands: ``REPEATS`` more launches bitwise
    equal to the first, and each slot alone (a one-slot batch of its query,
    table row and position) bitwise equal to its row of the batch.  A CPU
    rehearsal has no kernel to hold to this (its plain version's batched
    sums differ by slot count)."""
    if case["q"].device.type != "cuda":
        return {}
    (kp, vp), kw = _pool_args(case["pools"][0])
    q, bt, pos = case["q"][:, 0].contiguous(), case["bt"], case["positions"][:, 0].contiguous()
    first = fa.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    runs = [fa.paged_decode_attention(q, kp, vp, bt, pos, **kw) for _ in range(REPEATS)]
    alone = [fa.paged_decode_attention(q[i:i + 1].contiguous(), kp, vp, bt[i:i + 1].contiguous(),
                                       pos[i:i + 1].contiguous(), **kw)
             for i in range(q.shape[0])]
    sync(torch)
    for i, run in enumerate(runs):
        if not torch.equal(run, first):
            raise AssertionError(f"paged decode: launch {i + 2} of {REPEATS + 1} differs from "
                                 "the first on the same operands")
    for i, out in enumerate(alone):
        if not torch.equal(out[0], first[i]):
            raise AssertionError(f"paged decode: slot {i} alone differs from its row of the batch")
    # each stream its own queries over the same pages: the same counter size
    streams = two_streams_bitwise(torch, [
        lambda q=q: fa.paged_decode_attention(q, kp, vp, bt, pos, **kw)
        for q in (q, q.flip(0).contiguous())])
    return {"repeats_bitwise": REPEATS + 1, "slots_alone_bitwise": len(alone),
            "two_streams_bitwise": streams}


def kernel_phases(torch, F, fa, device: str = "cuda") -> dict:
    """Kernels #4 / #6, and #5 / #7 over int8 and fp8 pages, against their
    plain versions at the 600m shapes."""
    reports = {}
    quant_decode, quant_multi = [], []
    for kv_dtype in (None, "int8", "fp8"):
        cases = []
        for i, extra in enumerate(DEC_CASES):
            case = paged_case(torch, width=1, kv_dtype=kv_dtype, device=device, seed=i, **extra)
            rep = case_report(torch, F, fa, case, decode=True)
            if i == 0:
                rep["bitwise"] = decode_bitwise(torch, fa, case)
                rep["ptxas"] = DECODE_PTXAS
            log("kernel paged_decode_attention", json.dumps(rep))
            cases.append(rep)
            del case
        if kv_dtype is None:
            reports["paged_decode_attention"] = _with_cases(cases, cases[0])
        else:
            quant_decode += cases
        # #6 / #7: one prefill chunk, T in {16, 512}, starting at 0 or a
        # mid-table page boundary; the 512-token chunk from 0 is the main
        # path's shape
        cases = []
        for width in (16, 512):
            for pos0 in (0, 1024):
                rep = case_report(torch, F, fa, paged_case(torch, slots=1, width=width,
                                                           pos0=[pos0], seed=width + pos0,
                                                           kv_dtype=kv_dtype, device=device),
                                  decode=False)
                log("kernel paged_multitoken_attention", json.dumps(rep))
                cases.append(rep)
        # generate_paged's geometry: pages of 16, GEN_PAGED's batch of
        # prompts of ~250 tokens from position 0; and the serve's chunk over
        # pages of 32 (a page size the engine takes and #7 once refused)
        for extra in (dict(slots=GEN_PAGED["batch"], width=GEN_T, pos0=[0] * GEN_PAGED["batch"],
                           seed=GEN_T, page=16, n=-(-(GEN_T + GEN_PAGED["max_new"]) // 16)),
                      dict(slots=1, width=512, pos0=[0], seed=532, page=32,
                           n=2 * PLUGIN["pages_per_slot"])):
            rep = case_report(torch, F, fa, paged_case(torch, kv_dtype=kv_dtype, device=device,
                                                       **extra), decode=False)
            log("kernel paged_multitoken_attention", json.dumps(rep))
            cases.append(rep)
        is_main = lambda c: (c["shape"]["width"] == 512 and c["shape"]["pos0"] == [0]
                             and c["shape"]["page"] == PLUGIN["page_size"])
        if kv_dtype is None:
            reports["paged_multitoken_attention"] = _with_cases(cases, next(filter(is_main, cases)))
        else:
            quant_multi += cases
    # the quantized serve's pages are QUANT_KV's: its shapes are the main ones
    main = next(c for c in quant_decode if c["shape"]["kv_dtype"] == QUANT_KV
                and c["shape"]["page"] == PLUGIN["page_size"])
    reports["paged_decode_attention_quant"] = _with_cases(quant_decode, main)
    main = next(c for c in quant_multi if c["shape"]["kv_dtype"] == QUANT_KV and is_main(c))
    reports["paged_multitoken_attention_quant"] = _with_cases(quant_multi, main)
    return reports


# -- W8A16 matmul kernels #11, #12 --------------------------------------------

L2_BYTES = 50 * 2**20     # H100 L2


# filled by main(): ptxas's registers and spilled bytes of each #12 instance
WHOLEF_PTXAS: dict = {}


def qmm_kernel_phases(torch, F, device: str = "cuda") -> dict:
    """#11 and #12 against their plain versions at the 600m dense shapes,
    timed beside ``F.linear`` on the dequantized bf16 weight (and, with
    ``--before``, #12's earlier design).  Enough copies of each weight
    rotate between timed launches that each launch finds its codes out of
    the L2, as one dense of the real model does.  #12 at its main shape
    also runs on two streams at once, bitwise."""
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, dequantize, quantize

    gen = torch.Generator(device=device).manual_seed(11)
    qcfg = QuantizationConfig(load_in_8bit=True)
    readings = {name: [] for name in QMM_M}
    for label, (h, f) in QMM_SHAPES.items():
        copies = max(2, -(-2 * L2_BYTES // (h * f)))
        weights = [quantize((torch.randn(h, f, generator=gen, device=device) / h ** 0.5)
                            .bfloat16(), qcfg) for _ in range(copies)]
        dense = [dequantize(qt, torch.bfloat16).t().contiguous() for qt in weights]   # [F, H]
        for name, ms_m in QMM_M.items():
            kernel = getattr(qmm, name)
            plain = qmm.quantized_matmul_plain if name.endswith("tiled") \
                else qmm.quantized_matmul_wholef_plain
            for m in ms_m:
                x = torch.randn(m, h, generator=gen, device=device).bfloat16()
                qt = weights[0]
                out = kernel(x, qt.data, qt.scale, qblock=128, out_dtype=torch.bfloat16)
                again = kernel(x, qt.data, qt.scale, qblock=128, out_dtype=torch.bfloat16)
                sync(torch)
                if not torch.equal(out, again):
                    raise AssertionError(f"{name}: two runs on the same operands differ")
                ref = plain(x, qt.data, qt.scale, qblock=128, out_dtype=torch.float32)
                held = held_to_plain(torch, f"{name} {label} m {m}", out[:, None], ref[:, None])
                rot = lambda fn: (lambda i: fn(x, weights[i % copies].data,
                                               weights[i % copies].scale, qblock=128,
                                               out_dtype=torch.bfloat16))
                ms = time_ms(torch, rot(kernel), graph=True)
                plain_ms = time_ms(torch, rot(plain), iters=5)
                library_ms = time_ms(torch, lambda i: F.linear(x, dense[i % copies]), graph=True)
                nbytes = h * f + (f // 128) * h * 4 + m * h * 2 + m * f * 2
                bound_ms, bound_by = bound(nbytes, 2 * m * h * f)
                rep = {**held, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "shape": {"dense": label, "m": m, "H": h, "F": f, "qblock": 128,
                                 "weight_copies": copies}}
                if name.endswith("tiled"):
                    rep["shape"]["plan"] = vars(qmm.tiled_plan(m, h, f))
                else:
                    rep["shape"]["plan"] = vars(qmm.wholef_plan(m, h, f))
                    rep.update(before_wholef(torch, rot, x, qt, ref, label, m))
                    if (label, m) == QMM_MAIN[name] and x.device.type == "cuda":
                        xs = (x, torch.randn(m, h, generator=gen, device=device).bfloat16())
                        rep["two_streams_bitwise"] = two_streams_bitwise(torch, [
                            lambda x=x: kernel(x, qt.data, qt.scale, qblock=128) for x in xs])
                        rep["ptxas"] = WHOLEF_PTXAS
                log("kernel", name, json.dumps(rep))
                readings[name].append(rep)
        del weights, dense
    reports = {}
    for name, cases in readings.items():
        label, m = QMM_MAIN[name]
        main = next(c for c in cases if c["shape"]["dense"] == label and c["shape"]["m"] == m)
        reports[name] = _with_cases(cases, main)
        reports[name]["library_call"] = "F.linear on the dequantized bf16 weight"
    return reports


def before_wholef(torch, rot, x, qt, ref, label, m) -> dict:
    """#12's earlier design (``--before``) on the case's operands: held to
    the plain version and timed as the kernel is."""
    early = BEFORE.get("quantized_matmul_wholef")
    if early is None:
        return {}
    out = early(x, qt.data, qt.scale, qblock=128, out_dtype=torch.bfloat16)
    sync(torch)
    held = held_to_plain(torch, f"quantized_matmul_wholef {label} m {m} (earlier design)",
                         out[:, None], ref[:, None])
    return {"before_err_over_limit": held["err_over_limit"],
            "before_ms": time_ms(torch, rot(early), graph=True)}


# -- flash attention kernels #1-#3 -------------------------------------------

FLASH_HEADS = dict(h=MODEL["num_attention_heads"], hkv=MODEL["num_key_value_heads"],
                   d=MODEL["hidden_size"] // MODEL["num_attention_heads"])
FLASH_REPLACES = {"flash_fwd": "accelerate_tpu/ops/flash_attention.py:195",
                  "flash_dq": "accelerate_tpu/ops/flash_attention.py:329",
                  "flash_dkv": "accelerate_tpu/ops/flash_attention.py:375"}
REPEATS = 20          # back-to-back launches of #2 / #3 held bitwise to the first
# the kernel functions of #2 and #3 in flash_attention.cu (mangled name prefix)
BWD_FUNCTIONS = {"flash_dq": "flash_dq_kernel", "flash_dkv": "flash_dkv_kernel"}
# filled by main(): name -> per head dim, ptxas's registers and spills and
# the SASS's HGMMA and WARPGROUP.DEPBAR counts
SASS: dict = {}


def kernel_sass(lib: Path, ptxas: str) -> dict:
    """For #2 and #3 at each head dim: ptxas's registers, spilled bytes and
    whether it serialised the function's wgmmas (C7512 / C7513), from the build
    log; the ``HGMMA`` and ``WARPGROUP.DEPBAR`` counts of the SASS
    (``cuobjdump -sass`` of the library)."""
    from accelerate_tpu_torch.ops import _build

    out = {name: {} for name in BWD_FUNCTIONS}

    def entry(mangled):
        for name, fn in BWD_FUNCTIONS.items():
            m = re.match(rf"_ZN\S*{fn}ILi(\d+)E", mangled)
            if m:
                return out[name].setdefault(f"D{m.group(1)}", {})
        return None

    current = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = entry(m.group(1))
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = entry(m.group(1))
        if re.search(r"\(C751\d\)", line):   # "wgmma.mma_async instructions are serialized"
            m = re.search(r"function '(\S+)'", line)
            rec = entry(m.group(1)) if m else current
            if rec is not None:   # the reason ptxas gives
                rec["serialized"] = re.split(r" (?:for|in) the function",
                                             line.split("due to", 1)[-1])[0].strip()
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        log(f"no {cuobjdump}: the SASS counts are not measured")
        return out
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for block in sass.split("Function : ")[1:]:
        rec = entry(block.split()[0])
        if rec is not None:
            rec["hgmma"] = len(re.findall(r"\bHGMMA\.", block))
            rec["depbar"] = block.count("WARPGROUP.DEPBAR")
    return out


def flash_inputs(torch, *, b, t, seg=False, pos=False, lse_grad=False, seed=0, device="cuda",
                 dtype=None):
    """Random bf16 (or ``dtype``) q/k/v/g at the 600m attention geometry,
    an f32 gradient for the logsumexp (zero unless ``lse_grad``), and the
    mask options."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    dt = dtype or torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    q, g = rand(b, t, h, d).to(dt), rand(b, t, h, d).to(dt)
    k, v = rand(b, t, hkv, d).to(dt), rand(b, t, hkv, d).to(dt)
    g_lse = rand(b, t, h) if lse_grad else torch.zeros(b, t, h, device=device)
    kw = {}
    if seg:   # four packed segments per row
        cuts = torch.sort(torch.randint(1, t, (b, 3), generator=gen, device=device), dim=1).values
        kw["segment_ids"] = (torch.arange(t, device=device)[None, :, None] >= cuts[:, None]).sum(-1)
    if pos:   # shuffled positions: the causal diagonal is data dependent
        kw["positions"] = torch.stack([torch.randperm(t, generator=gen, device=device)
                                       for _ in range(b)]).int()
    return q, k, v, g, g_lse, kw


def flash_fwd_bwd(torch, fn, q, k, v, g, g_lse, causal, kw):
    """out, lse, dq, dk, dv of ``sum(out * g) + sum(lse * g_lse)``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v, causal=causal, return_lse=True, **kw)
    (out.float() * g.float()).sum().add((lse * g_lse).sum()).backward()
    return out.detach(), lse.detach(), q.grad, k.grad, v.grad


def flash_bound(b, t, valid_pairs):
    """Bytes and flops of each kernel for this data: each input read once
    and each output written once; 4 / 6 / 8 flops per head-dim element of
    each unmasked (query, key) pair for #1 / #2 / #3."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    q_bytes, kv_bytes, row_bytes = b * t * h * d * 2, b * t * hkv * d * 2, b * h * t * 4
    return {
        "flash_fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * d * valid_pairs),
        "flash_dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6 * d * valid_pairs),
        "flash_dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 8 * d * valid_pairs),
    }


def flash_kernel_phases(torch, F, fa, device: str = "cuda") -> dict:
    """#1-#3 against their plain versions at batch CHECK_BATCH on six
    cases and at the main path's batch; #3's determinism; times at the
    main path's batch."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    seq = TRAIN["seq"]
    cases = [dict(name="causal", t=seq), dict(name="segments", t=seq, seg=True),
             dict(name="positions", t=seq, pos=True),
             dict(name="non_causal", t=seq, causal=False),
             dict(name="t_not_tile_multiple", t=seq - 48),
             dict(name="lse_grad", t=seq, lse_grad=True)]
    readings = {name: [] for name in FLASH_REPLACES}
    for i, case in enumerate(cases):
        causal = case.get("causal", True)
        q, k, v, g, g_lse, kw = flash_inputs(torch, b=CHECK_BATCH, t=case["t"],
                                             seg=case.get("seg", False),
                                             pos=case.get("pos", False),
                                             lse_grad=case.get("lse_grad", False), seed=100 + i,
                                             device=device)
        got = flash_fwd_bwd(torch, fa.flash_attention, q, k, v, g, g_lse, causal, kw)
        sync(torch)
        want = flash_fwd_bwd(torch, fa.flash_attention_plain, q, k, v, g, g_lse, causal, kw)
        rep = {}
        for label, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            rep[label] = held_to_plain(torch, f"flash {case['name']} {label}", x, ref)
        log("kernel flash", case["name"], json.dumps(rep))
        for name, labels in (("flash_fwd", ("out", "lse")), ("flash_dq", ("dq",)),
                             ("flash_dkv", ("dk", "dv"))):
            readings[name] += [dict(rep[lb], case=case["name"], tensor=lb) for lb in labels]
        del got, want

    # the main path's shape: batch 10, causal.  Each kernel against its
    # plain version on the same operands (the backward ones on the
    # kernel's lse and delta, as the step gives them), #2 and #3 run twice
    b = TRAIN["batch"]
    q, k, v, g, _, _ = flash_inputs(torch, b=b, t=seq, seed=7, device=device)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
    dq_b = fa.flash_dq(q, k, v, g, lse, delta, **kw)
    dkv_a = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    dkv_b = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    sync(torch)
    if not torch.equal(dq, dq_b):
        raise AssertionError("flash_dq: two runs on the same operands differ")
    if not (torch.equal(dkv_a[0], dkv_b[0]) and torch.equal(dkv_a[1], dkv_b[1])):
        raise AssertionError("flash_dkv: two runs on the same operands differ")
    del dq_b, dkv_b
    # then 20 launches of each back to back: every output bitwise the
    # first's (a register of a wgmma in flight reused early shows here)
    for name, first in (("flash_dq", (dq,)), ("flash_dkv", dkv_a)):
        fn = getattr(fa, name)
        runs = [fn(q, k, v, g, lse, delta, **kw) for _ in range(REPEATS)]
        sync(torch)
        for i, run in enumerate(runs):
            run = run if isinstance(run, tuple) else (run,)
            if not all(torch.equal(x, y) for x, y in zip(first, run)):
                raise AssertionError(f"{name}: launch {i + 2} of {REPEATS + 1} differs from "
                                     "the first on the same operands")
        del runs
    log(f"flash_dq, flash_dkv: {REPEATS + 2} launches each on the same operands, bitwise equal")
    rep = {}
    for name, got, plain, labels in (
        ("flash_fwd", (out, lse), lambda: fa.flash_fwd_plain(q, k, v, **kw), ("out", "lse")),
        ("flash_dq", (dq,), lambda: (fa.flash_dq_plain(q, k, v, g, lse, delta, **kw),), ("dq",)),
        ("flash_dkv", dkv_a, lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw),
         ("dk", "dv")),
    ):
        for label, x, ref in zip(labels, got, plain()):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            rep[label] = held_to_plain(torch, f"flash B {b} {label}", x, ref)
            readings[name].append(dict(rep[label], case=f"causal_b{b}", tensor=label))
    log("kernel flash", f"causal_b{b}", json.dumps(rep))
    # #2 and #3's earlier mma.sync designs (--before): held to their plain
    # versions on the same operands and timed beside the new ones
    before = {}
    for name, labels in (("flash_dq", ("dq",)), ("flash_dkv", ("dk", "dv"))):
        if name not in BEFORE:
            continue
        early = BEFORE[name](q, k, v, g, lse, delta, **kw)
        sync(torch)
        early = early if isinstance(early, tuple) else (early,)
        refs = getattr(fa, name + "_plain")(q, k, v, g, lse, delta, **kw)
        refs = refs if isinstance(refs, tuple) else (refs,)
        early_rep = {label: held_to_plain(torch, f"{name} (earlier design) {label}", x, ref)
                     for label, x, ref in zip(labels, early, refs)}
        log("kernel flash", f"{name} earlier design causal_b{b}", json.dumps(early_rep))
        del early, refs
        before[name] = time_ms(torch, lambda i, fn=BEFORE[name]: fn(q, k, v, g, lse, delta, **kw))
    del out, dq, dkv_a
    ms = {"flash_fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v, **kw)),
          "flash_dq": time_ms(torch, lambda i: fa.flash_dq(q, k, v, g, lse, delta, **kw)),
          "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv(q, k, v, g, lse, delta, **kw))}
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda i: fa.flash_fwd_plain(q, k, v, **kw), iters=3, warmup=1),
        "flash_dq": time_ms(torch, lambda i: fa.flash_dq_plain(q, k, v, g, lse, delta, **kw),
                            iters=3, warmup=1),
        "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw),
                             iters=3, warmup=1)}
    # yardstick: SDPA on [B, H, T, D] copies (set-up not timed); its
    # backward computes dq, dk and dv in one call, set against #2 + #3
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gs = g.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda i: sdpa())
    out_s = sdpa()
    sdpa_bwd = time_ms(torch, lambda i: torch.autograd.grad(out_s, (qs, ks, vs), gs,
                                                           retain_graph=True))
    del out_s
    pairs = b * h * seq * (seq + 1) // 2
    bounds = flash_bound(b, seq, pairs)
    reports = {}
    for name in FLASH_REPLACES:
        worst = max(readings[name], key=lambda r: r["err_over_limit"])
        reports[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in readings[name]),
            "err_over_limit": worst["err_over_limit"], "worst": worst,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
            "library_call": ("F.scaled_dot_product_attention forward" if name == "flash_fwd"
                             else "its backward (dq, dk and dv in one call)"),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            **({"before_ms": before[name]} if name in before else {}),
            **({"sass": SASS[name]} if name in SASS else {}),
            "shape": {"batch": b, "seq": seq, "heads": h, "kv_heads": hkv, "head_dim": d,
                      "causal": True, "unmasked_pairs": pairs},
            "cases": [c["name"] for c in cases] + [f"causal_b{b}"],
        }
        log("kernel", name, json.dumps(reports[name]))
    log(f"flash at B {b}: fwd {ms['flash_fwd']:.4f} ms, dq {ms['flash_dq']:.4f} + dkv "
        f"{ms['flash_dkv']:.4f} = {ms['flash_dq'] + ms['flash_dkv']:.4f} ms"
        + (f" (earlier designs {before['flash_dq']:.4f} + {before['flash_dkv']:.4f} = "
           f"{before['flash_dq'] + before['flash_dkv']:.4f} ms)" if before else "")
        + f"; SDPA fwd {sdpa_fwd:.4f} ms, bwd {sdpa_bwd:.4f} ms")
    return reports


# -- the training step --------------------------------------------------------


@contextlib.contextmanager
def routed_flash(llama_mod, fn):
    """Route the model's uncached flash attention through ``fn``."""
    saved = llama_mod.flash_attention
    llama_mod.flash_attention = fn
    try:
        yield
    finally:
        llama_mod.flash_attention = saved


@contextlib.contextmanager
def checked_flash_kernels(torch, fa, readings: dict):
    """Hold every launch of #1-#3 against its plain version on the same
    operands while the block runs (the autograd function looks the kernel
    wrappers up when it calls them).  The checked launches count on the
    wrappers: read the main path's counts before."""
    saved = {n: getattr(fa, n) for n in FLASH_REPLACES}

    def check(name, outs, refs, labels):
        for label, x, ref in zip(labels, outs, refs):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            readings[name].append(held_to_plain(torch, f"{name} {label}", x, ref))

    def fwd(*args, **kw):
        out = saved["flash_fwd"](*args, **kw)
        check("flash_fwd", out, fa.flash_fwd_plain(*args, **kw), ("out", "lse"))
        return out

    def dq(*args, **kw):
        out = saved["flash_dq"](*args, **kw)
        check("flash_dq", [out], [fa.flash_dq_plain(*args, **kw)], ("dq",))
        return out

    def dkv(*args, **kw):
        out = saved["flash_dkv"](*args, **kw)
        check("flash_dkv", out, fa.flash_dkv_plain(*args, **kw), ("dk", "dv"))
        return out

    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = fwd, dq, dkv
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fa, n, f)


def worst_of(readings: dict, per_step: dict) -> dict:
    """Each kernel's worst reading over its checked calls, and the calls'
    count checked against ``per_step``."""
    rep = {}
    for name, calls in readings.items():
        n = len(calls) // (2 if name in ("flash_fwd", "flash_dkv") else 1)
        if n != per_step[name]:
            raise AssertionError(f"{name}: {n} checked launches, expected {per_step[name]}")
        worst = max(calls, key=lambda r: r["err_over_limit"])
        rep[name] = {"calls": n, "max_abs_err": max(r["max_abs_err"] for r in calls),
                     "err_over_tensor_max": max(r["err_over_tensor_max"] for r in calls),
                     **{k: worst[k] for k in ("err_over_limit", "worst_row_err",
                                              "worst_row_ref_max", "tensor_ref_max")}}
    return rep


def checked_step(torch, fa, acc, loss_fn, state, batch, layers: int):
    """One train step with every launch of #1-#3 held against its plain
    version on the step's own operands.  Returns the new state and each
    kernel's worst readings."""
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        state, _ = acc.prepare_train_step(loss_fn)(state, batch)
    return state, worst_of(readings, {n: layers for n in FLASH_REPLACES})


def train_setup(torch, seed: int = 0, device: str = "cuda"):
    """The 600m model, its bf16 params (lion-sr keeps the params themselves
    in bf16, norm scales included: bench.py's sr_recipe), the Accelerator
    and the loss."""
    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn,
    )
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=seed)
    params = {n: p.detach().to(torch.bfloat16) for n, p in model.named_parameters()}
    acc = Accelerator(mixed_precision="bf16", device=device,
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    return cfg, model, params, acc, loss_fn


def token_batch(torch, vocab: int, batch: int, device: str = "cuda"):
    tokens = np.random.default_rng(0).integers(0, vocab, (batch, TRAIN["seq"]))
    ids = torch.from_numpy(tokens).to(device)
    return {"input_ids": ids, "labels": ids}


def training_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """bench.py's 600m step: warm-up, timed steps with their launches, one
    checked batch-10 step, then the batch-2 checks against the plain
    versions."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch.accelerator import global_norm
    from accelerate_tpu_torch.models.llama import count_params, flops_per_token

    cfg, model, params, acc, loss_fn = train_setup(torch, device=device)
    state = acc.create_train_state(params, TRAIN["optimizer"])
    step = acc.prepare_train_step(loss_fn)   # lion family: no clipping (bench.py)
    batch = token_batch(torch, cfg.vocab_size, TRAIN["batch"], device)
    losses = []
    for _ in range(TRAIN["warmup"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    sync(torch)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    timed = []
    for _ in range(TRAIN["timed"]):
        state, m = step(state, batch)
        timed.append(m["loss"])
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {n: getattr(fa, n).launches for n in FLASH_REPLACES}
    losses += [float(x) for x in timed]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    layers = cfg.num_hidden_layers
    for name, count in launches.items():
        if count != TRAIN["timed"] * layers:
            raise AssertionError(f"{name} launched {count} times in {TRAIN['timed']} steps, "
                                 f"expected {layers} per step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    step_s = wall / TRAIN["timed"]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    fpt = flops_per_token(cfg, TRAIN["seq"])
    rep = {"card": card, "params": count_params(params), "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "optimizer": TRAIN["optimizer"], "step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "flops_per_token": fpt,
           "mfu_vs_989_tflops": fpt * tokens / step_s / BF16_FLOPS_PER_S,
           "max_memory_allocated_gib": peak / 2**30, "losses": losses,
           "launches_per_step": {n: c / TRAIN["timed"] for n, c in launches.items()}}
    log("train", json.dumps(rep))
    log(f"training on {card}: {rep['step_ms']:.1f} ms/step, {rep['tokens_per_s']:.0f} tokens/s, "
        f"MFU {100 * rep['mfu_vs_989_tflops']:.1f} % of the H100 SXM dense bf16 peak "
        f"(989 TFLOP/s), peak memory {rep['max_memory_allocated_gib']:.2f} GiB")
    # gate, outside the timed window: every launch of one more batch-10
    # step against its plain version on the step's own operands
    state, in_path = checked_step(torch, fa, acc, loss_fn, state, batch, layers)
    log("train_in_path", f"batch {TRAIN['batch']}", json.dumps(in_path))
    del state, params, model, step, m, timed
    if device == "cuda":
        torch.cuda.empty_cache()

    # gate: one step at CHECK_BATCH through the kernels and through the
    # plain versions, from the same weights
    cfg, model, params, acc, loss_fn = train_setup(torch, device=device)
    small = {k: v[:CHECK_BATCH] for k, v in batch.items()}
    start = {n: p.clone() for n, p in params.items()}

    def grads_of(route):
        leaves = {n: p.detach().requires_grad_() for n, p in start.items()}
        with routed_flash(llama_mod, route):
            loss = loss_fn(leaves, small).float()
        return loss.item(), torch.autograd.grad(loss, list(leaves.values()))

    loss_k, grads_k = grads_of(fa.flash_attention)
    loss_p, grads_p = grads_of(fa.flash_attention_plain)
    gn_k, gn_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    leaf_err = {n: ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
                for n, a, b in zip(start, grads_k, grads_p)}
    worst_leaf = max(leaf_err, key=leaf_err.get)
    step_metrics = {}
    for route_name, route in (("kernels", fa.flash_attention), ("plain", fa.flash_attention_plain)):
        st = acc.create_train_state({n: p.clone() for n, p in start.items()}, TRAIN["optimizer"])
        with routed_flash(llama_mod, route):
            _, m = acc.prepare_train_step(loss_fn)(st, small)
        step_metrics[route_name] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
        del st
    gate = {"loss_kernels": loss_k, "loss_plain": loss_p, "grad_norm_kernels": gn_k,
            "grad_norm_plain": gn_p, "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
            "grad_norm_rel": abs(gn_k - gn_p) / gn_p, "worst_leaf": worst_leaf,
            "worst_leaf_rel_err": leaf_err[worst_leaf],
            "median_leaf_rel_err": float(np.median(list(leaf_err.values()))),
            "step": step_metrics}
    log("train_vs_plain", json.dumps(gate))
    sm = step_metrics
    if (gate["loss_rel"] > LOSS_RTOL or gate["grad_norm_rel"] > GNORM_RTOL
            or gate["worst_leaf_rel_err"] > LEAF_RTOL
            or abs(sm["kernels"]["loss"] - sm["plain"]["loss"]) > LOSS_RTOL * abs(sm["plain"]["loss"])
            or abs(sm["kernels"]["grad_norm"] - sm["plain"]["grad_norm"])
            > GNORM_RTOL * sm["plain"]["grad_norm"]):
        raise AssertionError(f"the kernel step disagrees with the plain step: {gate}")
    del grads_k, grads_p

    # gate: every launch of a CHECK_BATCH step against its plain version
    st = acc.create_train_state({n: p.clone() for n, p in start.items()}, TRAIN["optimizer"])
    st, in_path_small = checked_step(torch, fa, acc, loss_fn, st, small, cfg.num_hidden_layers)
    log("train_in_path", f"batch {CHECK_BATCH}", json.dumps(in_path_small))
    del st, params, model, start
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "report": rep, "in_path": in_path,
            "in_path_check_batch": in_path_small}


RESUME = dict(steps=6, rows=40, sync_save=2, async_save=3, corrupt_save=4, fault_step=5,
              total_limit=3, init_seed_resumed=1)


def token_rows(torch, seed: int, vocab: int):
    """A ``torch.utils.data.Dataset`` of ``RESUME["rows"]`` token rows of
    ``TRAIN["seq"]`` made from ``seed`` with numpy; each item also carries
    its row index and a float weight of 1 (the loss is multiplied by the
    batch's mean weight, exactly 1, so the ``nan_grad`` fault has a float
    leaf to poison)."""
    tokens = np.random.default_rng(seed).integers(0, vocab, (RESUME["rows"], TRAIN["seq"]))

    class TokenRows(torch.utils.data.Dataset):
        def __len__(self):
            return len(tokens)

        def __getitem__(self, i):
            t = torch.from_numpy(tokens[i])
            return {"input_ids": t, "labels": t, "row": torch.tensor(i),
                    "weight": torch.ones((), dtype=torch.float32)}

    return TokenRows()


def host_state(torch, state) -> dict:
    """Device clones of a train state's params, lion-sr momentum and count."""
    return {"params": {n: p.clone() for n, p in state.params.items()},
            "mu": [m.clone() for m in state.opt_state.mu], "count": state.opt_state.count}


def state_diff(torch, a: dict, b: dict) -> dict:
    """Leaves that differ between two :func:`host_state` readings, with the
    largest |difference| of each (f32), and whether the counts agree."""
    diff = {}
    for name in a["params"]:
        x, y = a["params"][name], b["params"][name]
        if not torch.equal(x, y):
            diff[name] = (x.float() - y.float()).abs().max().item()
    for i, (x, y) in enumerate(zip(a["mu"], b["mu"])):
        if not torch.equal(x, y):
            diff[f"mu.{i}"] = (x.float() - y.float()).abs().max().item()
    return {"leaves": diff, "count_equal": a["count"] == b["count"],
            "bitwise": not diff and a["count"] == b["count"]}


def resume_run(torch, fa, seed: int, project: str, *, init_seed: int, plan, saves=False,
               resume=False, check=False, device: str = "cuda") -> dict:
    """One run of the loop the way a user drives it: a fresh Accelerator
    with the NaN guard and the preemption handler, a prepared DataLoader
    (seedable sampler, the native prefetch ring), the 600m model from
    ``init_seed``, ``maybe_resume`` with ``resume``, and steps under
    ``plan`` until step ``RESUME["steps"]`` or the preemption's exit.  With
    ``saves``: ``save_state()`` after step 2, ``save_state(async_save=True)``
    after step 3 and ``save_state()`` after step 4, and device clones of the
    state after steps 3 and 4.  With ``check``, one more step with every
    #1-#3 launch held against its plain version.  #1-#3 launch counts are
    read over the run's own steps."""
    from accelerate_tpu_torch import (
        Accelerator, DataLoaderConfiguration, GradSyncKwargs, LlamaConfig, LlamaForCausalLM,
        ProjectConfiguration, ResiliencePlugin, make_llama_loss_fn,
    )
    from accelerate_tpu_torch.resilience import fault_plan

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=init_seed)
    acc = Accelerator(
        mixed_precision="bf16", device=device,
        kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
        project_config=ProjectConfiguration(project_dir=project, automatic_checkpoint_naming=True,
                                            total_limit=RESUME["total_limit"]),
        resilience_plugin=ResiliencePlugin(nan_guard=True, handle_preemption=True),
        dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True, data_seed=seed))
    out = {"rows": [], "losses": [], "exit_code": None, "saves": {}}
    try:
        loader = acc.prepare(torch.utils.data.DataLoader(
            token_rows(torch, seed, cfg.vocab_size), batch_size=TRAIN["batch"], shuffle=True))
        state = acc.create_train_state({n: p.detach() for n, p in model.named_parameters()},
                                       TRAIN["optimizer"])
        if resume:
            sync(torch)
            t0 = time.perf_counter()
            state = acc.maybe_resume(train_state=state)
            sync(torch)
            out["load_ms"] = (time.perf_counter() - t0) * 1e3
            out["restored_from"] = acc.last_restored_checkpoint
            out["restored"] = host_state(torch, state)
            out["restored_nan_skips"] = int(state.guard_state["nan_skips"])
        base = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])

        def loss_fn(params, batch):
            return base(params, batch) * batch["weight"].mean()

        step = acc.prepare_train_step(loss_fn)
        sync(torch)
        fa.reset_launch_counts()
        executed, first_wait = 0, 0.0
        t_loop = time.perf_counter()
        with fault_plan(plan):
            try:
                while acc.step_count < RESUME["steps"]:
                    for batch in loader:
                        out["rows"].append(batch["row"])
                        if saves and acc.step_count == RESUME["fault_step"] - 1:
                            out["step4"] = host_state(torch, state)
                        executed += 1
                        state, m = step(state, batch)
                        if executed == 1:
                            # the pass's first batch starts the prefetch ring
                            first_wait = loader.data_wait_s
                        out["losses"].append(m["loss"])
                        n = acc.step_count
                        if saves and n in (RESUME["sync_save"], RESUME["async_save"],
                                           RESUME["corrupt_save"]):
                            if n == RESUME["async_save"]:
                                out["step3"] = host_state(torch, state)
                            sync(torch)
                            path = acc.save_state(train_state=state,
                                                  async_save=n == RESUME["async_save"])
                            out["saves"][n] = path
                        if acc.step_count >= RESUME["steps"]:
                            break
            except SystemExit as e:
                out["exit_code"] = e.code
        sync(torch)
        out["loop_s"] = time.perf_counter() - t_loop
        out["executed"] = executed
        out["launches"] = {name: getattr(fa, name).launches for name in FLASH_REPLACES}
        out["data_wait_ms_per_step"] = loader.data_wait_s / max(executed, 1) * 1e3
        out["data_wait_first_ms"] = first_wait * 1e3
        out["data_wait_ms_after_first"] = ((loader.data_wait_s - first_wait)
                                           / max(executed - 1, 1) * 1e3)
        out["h2d_issue_ms_per_step"] = loader._stager.h2d_s / max(executed, 1) * 1e3
        out["losses"] = [float(x) for x in out["losses"]]
        out["rows"] = [r.tolist() for r in out["rows"]]
        out["goodput"] = acc.goodput.state_dict()
        out["goodput_frac"] = acc.goodput.goodput_frac()
        out["checkpoint_log"] = acc.checkpoint_log
        if out["exit_code"] is None:
            out["final"] = host_state(torch, state)
            out["nan_skips"] = int(state.guard_state["nan_skips"])
            if check:
                batch = next(iter(loader))
                _, out["in_path"] = checked_step(torch, fa, acc, loss_fn, state, batch,
                                                 cfg.num_hidden_layers)
        else:
            out["params_after_exit"] = {n: p.clone() for n, p in state.params.items()}
        acc.end_training()
    finally:
        acc.uninstall_preemption_handler()
    return out


def train_resume_phase(torch, fa, card: str, seed: int, step_ms: float, n_params: int,
                       device: str = "cuda") -> dict:
    """The resumable 600m training loop through a prepared DataLoader (the
    module docstring's step 6a): the clean run twice (run-to-run check),
    the saved run preempted at step 5, the resume in a fresh Accelerator
    from another init, the fallback scan past two corrupt checkpoints."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.checkpointing import list_checkpoints, verify_checkpoint
    from accelerate_tpu_torch.models.llama import LlamaConfig
    from accelerate_tpu_torch.resilience import (
        FaultEvent, FaultPlan, RESUME_EXIT_CODE, corrupt_checkpoint, goodput_accounting,
    )

    if not native.is_available():
        raise AssertionError("the native IO engine did not build (g++): checkpoints would "
                             "take the pure-Python path")
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    root = Path(tempfile.mkdtemp(prefix="train_resume-"))
    try:
        free = shutil.disk_usage(root).free
        # bf16 params + lion-sr's bf16 momentum, two bytes each per param;
        # at most total_limit checkpoints are on disk at once
        ckpt_bytes = n_params * 4
        need = RESUME["total_limit"] * ckpt_bytes + (1 << 30)
        if free < need:
            raise AssertionError(f"{root}: {free / 2**30:.1f} GiB free, the phase needs "
                                 f"{need / 2**30:.1f} GiB for {RESUME['total_limit']} "
                                 f"checkpoints of {ckpt_bytes / 2**30:.2f} GiB")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        nan_plan = lambda: FaultPlan([FaultEvent("nan_grad", at=RESUME["fault_step"])])  # noqa: E731
        clean = resume_run(torch, fa, seed, str(root / "clean"), init_seed=seed, plan=nan_plan(),
                           device=device)
        again = resume_run(torch, fa, seed, str(root / "clean_again"), init_seed=seed,
                           plan=nan_plan(), device=device)
        run_to_run = state_diff(torch, clean["final"], again["final"])
        del again

        project = str(root / "run")
        plan = FaultPlan([FaultEvent("corrupt_ckpt", at=3, mode="bitflip"),
                          FaultEvent("nan_grad", at=RESUME["fault_step"]),
                          FaultEvent("preempt", at=RESUME["fault_step"])], seed=seed)
        saved = resume_run(torch, fa, seed, project, init_seed=seed, plan=plan, saves=True,
                           device=device)
        if saved["exit_code"] != RESUME_EXIT_CODE:
            raise AssertionError(f"the preempted run exited with {saved['exit_code']}, "
                                 f"not {RESUME_EXIT_CODE}")
        ckpts = list_checkpoints(project)
        valid = {Path(c).name: verify_checkpoint(c)[0] for c in ckpts}
        # the nan_grad step left the params bitwise as step 4 left them
        nan_step_params = all(torch.equal(saved["params_after_exit"][n], p)
                              for n, p in saved["step4"]["params"].items())
        del saved["params_after_exit"]

        resumed = resume_run(torch, fa, seed, project, init_seed=RESUME["init_seed_resumed"],
                             plan=None, resume=True, check=True, device=device)
        emergency = ckpts[-1]
        nan_step = state_diff(torch, saved.pop("step4"), resumed.pop("restored"))
        final = state_diff(torch, clean.pop("final"), resumed.pop("final"))
        stream_equal = saved["rows"] + resumed["rows"] == clean["rows"]

        # the fallback scan: with the emergency checkpoint corrupted too, a
        # fresh load walks past it and the plan's corrupted step-4 save to
        # the async step-3 checkpoint, which must hold step 3's values
        corrupt_checkpoint(emergency, mode="bitflip", seed=seed)
        t0 = time.perf_counter()
        verify_ok = verify_checkpoint(saved["saves"][RESUME["async_save"]])
        verify_ms = (time.perf_counter() - t0) * 1e3
        params_file = Path(saved["saves"][RESUME["async_save"]]) / "train_state" / "params.safetensors"
        t0 = time.perf_counter()
        native.file_crc32(params_file)
        crc_s = time.perf_counter() - t0
        scan = fallback_scan(torch, seed, project, device)
        async_holds = state_diff(torch, saved["step3"], scan["restored"])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        log_ = saved["checkpoint_log"]
        by_step = {n: log_[path] for n, path in saved["saves"].items()}
        sync_rec, async_rec = by_step[RESUME["sync_save"]], by_step[RESUME["async_save"]]
        gp = resumed["goodput"]
        expected_gp = {"steps": RESUME["steps"], "nan_skips": 1, "restarts": 1,
                       "preemptions": 1, "steps_recomputed": 0, "time_lost_s": 0.0,
                       "io_retries": 0, "transfer_retries": 0}
        step_s = clean["loop_s"] / clean["executed"]
        # CheckFreq's model at this run's settings: a checkpoint every step
        # costing the async save's blocking time, one preemption in the
        # run's six steps, the resume's load as the restart overhead
        predicted = goodput_accounting(
            step_s, 1, save_overhead_s=async_rec["blocking_s"],
            preemption_rate_per_hour=3600.0 / (RESUME["steps"] * step_s),
            restart_overhead_s=resumed["load_ms"] / 1e3)
        layers = cfg.num_hidden_layers
        launches = {name: saved["launches"][name] + resumed["launches"][name]
                    for name in FLASH_REPLACES}
        rep = {
            "card": card, "params": n_params, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "steps": RESUME["steps"], "checkpoint_bytes": sync_rec["bytes"],
            "save_sync_ms": sync_rec["blocking_s"] * 1e3,
            "save_async_blocking_ms": async_rec["blocking_s"] * 1e3,
            "save_async_total_ms": (async_rec["written_at"] - async_rec["started_at"]) * 1e3,
            "write_gb_per_s": sync_rec["bytes"] / sync_rec["write_s"] / 1e9,
            "manifest_crc32_ms": sync_rec["manifest_s"] * 1e3,
            "crc32_ms_params_file": crc_s * 1e3,
            "crc32_gb_per_s": params_file.stat().st_size / crc_s / 1e9,
            "verify_ms": verify_ms, "load_ms": resumed["load_ms"],
            "data_wait_ms_per_step": clean["data_wait_ms_per_step"],
            "data_wait_first_ms": clean["data_wait_first_ms"],
            "data_wait_ms_after_first": clean["data_wait_ms_after_first"],
            "h2d_issue_ms_per_step": clean["h2d_issue_ms_per_step"],
            "loader_step_ms": step_s * 1e3, "fixed_batch_step_ms": step_ms,
            "max_memory_allocated_gib": peak / 2**30,
            "clean_losses": clean["losses"], "resumed_losses": resumed["losses"],
            "run_to_run_bitwise": run_to_run["bitwise"],
            "run_to_run_leaves": run_to_run["leaves"],
            "resume_bitwise": final["bitwise"], "resume_leaves": final["leaves"],
            "nan_step_unchanged": nan_step_params and nan_step["bitwise"],
            "nan_skips_after_resume": resumed["restored_nan_skips"],
            "async_checkpoint_holds_step_3": async_holds["bitwise"],
            "restored_from": Path(resumed["restored_from"]).name,
            "fallback_restored": Path(scan["restored_from"]).name,
            "fallback_explicit_corrupt_raises": scan["explicit_raises"],
            "checkpoints_valid": valid, "stream_equal": stream_equal,
            "goodput": gp, "goodput_frac": resumed["goodput_frac"],
            "goodput_predicted": predicted["goodput_frac"],
            "launches_per_step": {n: c / (saved["executed"] + resumed["executed"])
                                  for n, c in launches.items()},
            "in_path": resumed["in_path"],
        }
        log("train_resume", json.dumps(rep))
        failures = []
        if valid.get(Path(saved["saves"][RESUME["corrupt_save"]]).name, True):
            failures.append("the step-4 checkpoint was not corrupted by the plan")
        if Path(resumed["restored_from"]).name != Path(emergency).name:
            failures.append(f"resumed from {resumed['restored_from']}, not the emergency "
                            f"checkpoint {emergency}")
        if Path(scan["restored_from"]).name != Path(saved["saves"][RESUME["async_save"]]).name:
            failures.append(f"the fallback scan restored {scan['restored_from']}")
        if not scan["explicit_raises"]:
            failures.append("an explicit load of the corrupt checkpoint did not raise")
        if not (verify_ok[0] and async_holds["bitwise"]):
            failures.append(f"the async checkpoint does not hold step 3: {async_holds}")
        if not rep["nan_step_unchanged"] or resumed["restored_nan_skips"] != 1:
            failures.append(f"the NaN step changed the state: {nan_step}, "
                            f"nan_skips {resumed['restored_nan_skips']}")
        if not stream_equal:
            failures.append("the batch stream differs from the clean run's")
        if run_to_run["bitwise"] and not final["bitwise"]:
            failures.append(f"the resume is not bitwise the clean run: {final}")
        if not run_to_run["bitwise"]:
            spread = max(run_to_run["leaves"].values(), default=0.0)
            worst = max(final["leaves"].values(), default=0.0)
            if worst > spread or not final["count_equal"]:
                failures.append(f"the resume differs by {worst}, wider than the run-to-run "
                                f"spread {spread}")
        if gp != expected_gp:
            failures.append(f"goodput counters {gp}, expected {expected_gp}")
        for name, count in launches.items():
            steps_run = saved["executed"] + resumed["executed"]
            if count != steps_run * layers:
                failures.append(f"{name} launched {count} times in {steps_run} steps")
        if not all(math.isfinite(x) for x in clean["losses"][:RESUME["fault_step"] - 1]):
            failures.append(f"clean losses not finite: {clean['losses']}")
        if failures:
            raise AssertionError("train_resume: " + "; ".join(failures))
        return {"launches": launches, "report": rep}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if device == "cuda":
            torch.cuda.empty_cache()


# (h) the recovery ladder on the 600m loop in one process: peer snapshots
# every 2 steps (JAX's _buddy pairs the odd rank out with itself, so the
# peer rung reads the rank's own host waves), batch 2 x 2048 (cut from the
# step's 10: the ladder replays steps, the rows are not what it measures)
LADDER = dict(batch=2, steps=6, every=2, fault_step=5, disk_save=2)


def recovery_ladder(torch, fa, card: str, device: str = "cuda") -> dict:
    """(h): an uninterrupted reference pass, then a ``rank_loss`` at step 5
    recovered from the peer rung (wave 4), a ``partial_ckpt`` tearing wave
    4 (recovery drops it by crc, restores wave 2), ``forget_local()`` (the
    disk rung, a checkpoint at step 2), ``reset()`` with the checkpoints
    gone (a fresh start); each restoring pass continues bitwise with the
    reference, every #1-#3 launch of the faulted passes held to its plain
    version.  Times phase 1's host copy and crc against the step, each
    rung's restore, one ``straggler`` stall."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, ProjectConfiguration,
        ResiliencePlugin, make_llama_loss_fn,
    )
    from accelerate_tpu_torch.resilience import (
        STRAGGLER_STALL_S, FaultEvent, FaultPlan, RankLostError, install_fault_plan,
    )
    from accelerate_tpu_torch.resilience import peer_ckpt as pc
    from accelerate_tpu_torch.telemetry import twin_registry

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=8)
    root = Path(tempfile.mkdtemp(prefix="recovery-"))
    acc = Accelerator(mixed_precision="bf16", device=device,
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
                      project_config=ProjectConfiguration(project_dir=str(root),
                                                          automatic_checkpoint_naming=True),
                      resilience_plugin=ResiliencePlugin(peer_snapshot_every=LADDER["every"]))
    try:
        state0 = acc.create_train_state(model, TRAIN["optimizer"])
        init = pc.capture_host_snapshot(state0)
        step = acc.prepare_train_step(make_llama_loss_fn(model,
                                                         fused_vocab_chunks=TRAIN["ce_chunks"]))
        tokens = np.random.default_rng(9).integers(
            0, cfg.vocab_size, (LADDER["steps"], LADDER["batch"], TRAIN["seq"]))
        batches = [{"input_ids": t, "labels": t}
                   for t in torch.from_numpy(tokens).to(device).unbind(0)]
        reg = twin_registry()
        reg.reset()
        reset_counts()
        executed = 0

        def fresh():
            acc.step_count = 0
            return pc.restore_host_snapshot(init, state0)

        # the reference pass, timed, kernels not held (their launches count)
        state, ref, step_ms = fresh(), [], []
        for b in batches:
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, b)
            ref.append(m["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        executed += len(batches)
        snapper = acc.peer_snapshotter
        predicted = pc.peer_ckpt_accounting(state)["snapshot_bytes"]
        measured = snapper.local[-1].nbytes

        # phase 1 alone: the synchronous host copy, then the crc32s
        copy_ms, crc_ms = [], []
        for _ in range(3):
            leaves = pc._flat_leaves(state)
            sync(torch)
            t0 = time.perf_counter()
            host = {k: pc._host_copy(v) for k, v in leaves.items()}
            sync(torch)
            copy_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for v in host.values():
                pc._crc(v)
            crc_ms.append((time.perf_counter() - t0) * 1e3)
            del host

        readings = {n: [] for n in FLASH_REPLACES}

        def run_pass(plan, disk_save_at=None, before_recover=None):
            nonlocal executed
            snapper.reset()
            install_fault_plan(FaultPlan(plan))
            state = fresh()
            losses, report, prefix, i = [], None, 0, 0
            try:
                while i < len(batches):
                    try:
                        out, m = step(state, batches[i])
                    except RankLostError:
                        prefix = len(losses)
                        if before_recover is not None:
                            before_recover()
                        sync(torch)
                        state, report = acc.recover(train_state=state,
                                                    load_sampler_states=False)
                        if state is None:
                            raise AssertionError(f"recovery fell through to fresh: {report}")
                        i = acc.step_count
                        continue
                    executed += 1
                    state = out
                    losses.append(m["loss"].item())
                    i += 1
                    if disk_save_at == i:
                        acc.save_state(train_state=state)
            finally:
                install_fault_plan(None)
            if report is None:
                raise AssertionError("the fault plan never fired")
            expect = ref[:prefix] + ref[report["restored_step"]:]
            return {**{k: report[k] for k in ("restore_path", "restored_step",
                                              "steps_recomputed", "peer_snapshot_bytes")},
                    "restore_ms": report["restore_time_s"] * 1e3,
                    "losses": losses, "bitwise": losses == expect}, state

        at = LADDER["fault_step"]
        with checked_flash_kernels(torch, fa, readings):
            peer, _ = run_pass([FaultEvent("rank_loss", at=at)])
            torn, _ = run_pass([FaultEvent("partial_ckpt", at=2),
                                FaultEvent("rank_loss", at=at)])
            disk, state = run_pass([FaultEvent("rank_loss", at=at)],
                                   disk_save_at=LADDER["disk_save"],
                                   before_recover=snapper.forget_local)
        snapper.reset()
        shutil.rmtree(root / "checkpoints")
        gone, fresh_rep = acc.recover(train_state=state, load_sampler_states=False)
        fresh_step_count = acc.step_count
        # one straggler stall, against the step without it (no snapshot in
        # either step)
        acc.resilience_plugin.peer_snapshot_every = 0
        timed = []
        for plan in ([], [FaultEvent("straggler", at=1)]):
            install_fault_plan(FaultPlan(plan))
            try:
                sync(torch)
                t0 = time.perf_counter()
                state, _ = step(state, batches[0])
                sync(torch)
                timed.append((time.perf_counter() - t0) * 1e3)
            finally:
                install_fault_plan(None)
        executed += 2
        launches = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
        twin = reg.get("recovery.peer_snapshot_bytes")
        nbytes = measured
        odd = [ms for i, ms in enumerate(step_ms) if (i + 1) % LADDER["every"] and i]
        rep = {
            "card": card, "batch": [LADDER["batch"], TRAIN["seq"]], "every": LADDER["every"],
            "snapshot_bytes_predicted": predicted, "snapshot_bytes_measured": measured,
            "twin_rel_err": twin.rel_err if twin is not None else None,
            "ref_losses": ref, "step_ms": step_ms,
            "step_ms_without_snapshot": float(np.median(odd)),
            "phase1_copy_ms": float(np.median(copy_ms)),
            "phase1_copy_gb_s": nbytes / (float(np.median(copy_ms)) / 1e3) / 1e9,
            "phase1_crc_ms": float(np.median(crc_ms)),
            "phase1_crc_gb_s": nbytes / (float(np.median(crc_ms)) / 1e3) / 1e9,
            "peer": peer, "peer_older_wave": torn, "disk": disk,
            "fresh": {"restore_path": fresh_rep["restore_path"], "restored": gone is not None,
                      "step_count": fresh_step_count,
                      "restore_ms": fresh_rep["restore_time_s"] * 1e3},
            "goodput": acc.goodput.state_dict(),
            "straggler": {"step_ms": timed[0], "with_stall_ms": timed[1],
                          "stall_ms": timed[1] - timed[0], "stall_s_set": STRAGGLER_STALL_S},
            "launches": launches, "executed_steps": executed,
            "in_path": worst_of(readings, {n: (executed - len(batches) - 2)
                                           * cfg.num_hidden_layers for n in FLASH_REPLACES}),
        }
        log("train_resume (h) recovery ladder:", json.dumps(rep))
        failures = []
        if predicted != measured or (twin is not None and twin.rel_err != 0.0):
            failures.append(f"snapshot bytes predicted {predicted}, measured {measured}")
        for label, want_path, want_step in (("peer", "peer", 4), ("peer_older_wave", "peer", 2),
                                            ("disk", "disk", LADDER["disk_save"])):
            r = rep[label]
            if (r["restore_path"], r["restored_step"]) != (want_path, want_step) \
                    or not r["bitwise"]:
                failures.append(f"{label}: {r}")
        if fresh_rep["restore_path"] != "fresh" or gone is not None or fresh_step_count != 0:
            failures.append(f"fresh: {rep['fresh']}")
        if rep["straggler"]["stall_ms"] < STRAGGLER_STALL_S * 1e3 * 0.9:
            failures.append(f"straggler: {rep['straggler']}")
        for n, c in launches.items():
            if c != executed * cfg.num_hidden_layers:
                failures.append(f"{n} launched {c} times in {executed} steps")
        if failures:
            raise AssertionError("train_resume (h): " + "; ".join(failures))
        return rep
    finally:
        shutil.rmtree(root, ignore_errors=True)
        acc = model = None
        if device == "cuda":
            torch.cuda.empty_cache()


def fallback_scan(torch, seed: int, project: str, device: str) -> dict:
    """A fresh Accelerator's ``load_state()`` over ``project`` (the newest
    checkpoints corrupt), and an explicit ``load_state`` of the newest,
    which must raise."""
    from accelerate_tpu_torch import (
        Accelerator, LlamaConfig, LlamaForCausalLM, ProjectConfiguration, ResiliencePlugin,
    )
    from accelerate_tpu_torch.checkpointing import CheckpointCorruptError, list_checkpoints

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=RESUME["init_seed_resumed"])
    acc = Accelerator(mixed_precision="bf16", device=device,
                      project_config=ProjectConfiguration(project_dir=project,
                                                          automatic_checkpoint_naming=True),
                      resilience_plugin=ResiliencePlugin(nan_guard=True))
    template = acc.create_train_state({n: p.detach() for n, p in model.named_parameters()},
                                      TRAIN["optimizer"])
    try:
        acc.load_state(list_checkpoints(project)[-1], train_state=template)
        explicit_raises = False
    except CheckpointCorruptError:
        explicit_raises = True
    state = acc.load_state(train_state=template)
    return {"restored": host_state(torch, state), "restored_from": acc.last_restored_checkpoint,
            "explicit_raises": explicit_raises}


@contextlib.contextmanager
def routed_attention(llama_mod, decode, multitoken):
    """Route the model's paged attention through ``decode`` / ``multitoken``
    in place of the kernel wrappers while the block runs."""
    saved = (llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention)
    llama_mod.paged_decode_attention = decode
    llama_mod.paged_multitoken_attention = multitoken
    try:
        yield
    finally:
        llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention = saved


@contextlib.contextmanager
def routed_qmm(qmm, tiled, wholef):
    """Route the W8A16 matmuls through ``tiled`` / ``wholef`` in place of
    the kernel wrappers (``quantized_matmul`` looks them up when called)."""
    saved = (qmm.quantized_matmul_tiled, qmm.quantized_matmul_wholef)
    qmm.quantized_matmul_tiled, qmm.quantized_matmul_wholef = tiled, wholef
    try:
        yield
    finally:
        qmm.quantized_matmul_tiled, qmm.quantized_matmul_wholef = saved


def checked(torch, kernel, plain, readings: list):
    """``kernel``'s wrapper, followed on every call by its plain version in
    f32 on the same operands (quantized pages as they are, with their
    scales); each call's readings go to ``readings``."""
    def call(q, k_pages, v_pages, block_tables, positions, **kw):
        out = kernel(q, k_pages, v_pages, block_tables, positions, **kw)
        quant = kw.get("k_scales") is not None
        ref = plain(q.float(), k_pages if quant else k_pages.float(),
                    v_pages if quant else v_pages.float(), block_tables, positions, **kw)
        readings.append({**held_to_plain(torch, kernel.__name__, out, ref),
                         "width": q.shape[1] if q.dim() == 4 else 1})
        return out
    return call


def checked_qmm(torch, kernel, plain, readings: list):
    """A W8A16 wrapper followed on every call by its plain version with f32
    output; rows are output rows."""
    def call(x, codes, scales, *, qblock, out_dtype=None):
        out = kernel(x, codes, scales, qblock=qblock, out_dtype=out_dtype)
        ref = plain(x, codes, scales, qblock=qblock, out_dtype=torch.float32)
        readings.append(held_to_plain(torch, kernel.__name__, out[:, None], ref[:, None]))
        return out
    return call


@contextlib.contextmanager
def routed_bgmv(lora_mod, fn):
    """Route the LoRA route's kernel #10 through ``fn`` (``lora_apply``
    looks ``bgmv_apply`` up when called)."""
    saved = lora_mod.bgmv_apply
    lora_mod.bgmv_apply = fn
    try:
        yield
    finally:
        lora_mod.bgmv_apply = saved


def checked_bgmv(torch, lora_mod, readings: list):
    """Kernel #10 (``bgmv_apply``) followed on every call by its plain
    version in f32 on the same operands (``lora_plain``); rows are slots,
    and id-0 rows must be ``y`` bitwise."""
    kernel = lora_mod.bgmv_apply

    def call(x, y, a_stack, b_stack, ids):
        out = kernel(x, y, a_stack, b_stack, ids)
        ref, slack = lora_plain(torch, lora_mod, x, y, a_stack, b_stack, ids)
        readings.append(held_to_plain(torch, "bgmv_apply", out[:, None], ref[:, None],
                                      slack=slack[:, None]))
        base = ids == 0
        if not torch.equal(out[base].view(torch.int16), y[base].view(torch.int16)):
            raise AssertionError("bgmv_apply: an id-0 row is not y bitwise")
        return out
    return call


@contextlib.contextmanager
def checked_kernels(torch, llama_mod, fa, qmm, readings: dict):
    """Every launch of the paged kernels, the W8A16 matmuls and the LoRA
    kernel #10 held against its plain version while the block runs;
    readings by kernel name.  The checked launches count on the wrappers:
    read the main path's counts before."""
    from accelerate_tpu_torch.ops import lora as lora_mod

    for name in ("paged_decode_attention", "paged_multitoken_attention",
                 "quantized_matmul_tiled", "quantized_matmul_wholef", "bgmv_apply"):
        readings.setdefault(name, [])
    decode = checked(torch, fa.paged_decode_attention, fa.paged_decode_attention_plain,
                     readings["paged_decode_attention"])
    multitoken = checked(torch, fa.paged_multitoken_attention,
                         fa.paged_multitoken_attention_plain,
                         readings["paged_multitoken_attention"])
    tiled = checked_qmm(torch, qmm.quantized_matmul_tiled, qmm.quantized_matmul_plain,
                        readings["quantized_matmul_tiled"])
    wholef = checked_qmm(torch, qmm.quantized_matmul_wholef, qmm.quantized_matmul_wholef_plain,
                         readings["quantized_matmul_wholef"])
    with (routed_bgmv(lora_mod, checked_bgmv(torch, lora_mod, readings["bgmv_apply"])),
          routed_attention(llama_mod, decode, multitoken), routed_qmm(qmm, tiled, wholef)):
        yield


def worst_readings(readings: dict, required) -> dict:
    """Each kernel's number of checked calls and worst readings; raises if
    a ``required`` kernel was never called."""
    rep = {}
    for name, calls in readings.items():
        if not calls:
            if name in required:
                raise AssertionError(f"{name}: no launch in the checked pass")
            continue
        worst = max(calls, key=lambda r: r["err_over_limit"])
        rep[name] = {"calls": len(calls), "max_abs_err": max(r["max_abs_err"] for r in calls),
                     **{k: worst[k] for k in ("err_over_limit", "worst_row_err",
                                              "worst_row_ref_max")},
                     "min_row_ref_max": min(r["min_row_ref_max"] for r in calls)}
        if "width" in worst:
            widths: dict = {}
            for r in calls:
                widths[r["width"]] = widths.get(r["width"], 0) + 1
            rep[name]["calls_by_width"] = dict(sorted(widths.items()))
    return rep


def capped(trace, new: int) -> list:
    """``trace``'s requests with their new tokens capped at ``new``."""
    import dataclasses

    return [dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens, new)) for r in trace]


def hold_contract(engine, label: str = "") -> None:
    """Raise where the serving resource contract
    (``verify_serving_invariants``) fails on ``engine``."""
    from accelerate_tpu_torch.serving import verify_serving_invariants

    problems = verify_serving_invariants(engine)
    if problems:
        raise AssertionError(f"{label}tick {engine.steps}: {problems}")


def drive(engine, trace, on_tick=None) -> int:
    """Serve ``trace`` on ``engine`` tick by tick, each request added at
    its arrival step, calling ``on_tick(engine)`` after every tick;
    returns the ticks."""
    pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
    ticks = 0
    while pending or not engine.idle():
        while pending and pending[0].arrival_step <= engine.steps:
            engine.add_request(pending.pop(0))
        engine.step()
        ticks += 1
        if on_tick is not None:
            on_tick(engine)
    return ticks


def in_path_check(torch, model, llama_mod, fa, qmm, trace, kv_dtype="bf16",
                  adapters=None, plugin=PLUGIN, required=None, draft_model=None,
                  invariants=False) -> dict:
    """Serve ``trace`` (each request's new tokens capped at ``CHECKED_NEW``)
    on a fresh engine with every kernel launch held against its plain
    version on the operands the engine gives it: the
    allocator's block tables, bucket-padded prefill windows, the dead slots
    of each decode step, the dead lanes of each verify pass and, with
    ``adapters`` (a fresh store), each slot's adapter ids.  ``required``
    (default: #4 and #6, #11 with int8 weights, #10 with adapters) must
    each be called; with ``invariants`` the serving resource contract
    (``verify_serving_invariants``: the page mirror, refcounts, the free
    stack) is checked after every tick.  Returns each kernel's worst
    readings."""
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin

    engine = ServingEngine(model, ServingPlugin(**plugin, kv_dtype=kv_dtype),
                           GenerationConfig(max_new_tokens=MAX_NEW), device=model.device,
                           adapters=adapters, draft_model=draft_model)
    engine.warmup()
    readings = {}
    with checked_kernels(torch, llama_mod, fa, qmm, readings):
        ticks = drive(engine, capped(trace, CHECKED_NEW), hold_contract if invariants else None)
    if required is None:
        required = ["paged_decode_attention", "paged_multitoken_attention"]
        if kv_dtype != "bf16":
            required.append("quantized_matmul_tiled")
        if adapters is not None:
            required.append("bgmv_apply")
    rep = worst_readings(readings, required)
    if invariants:
        rep["invariants_checked_ticks"] = ticks
    return rep


def teacher_forced_logits(torch, model, llama_mod, fa, qmm, request, generated,
                          kv_dtype="bf16", adapters=None):
    """Run prompt + generated tokens through the model's paged path twice,
    with the kernels and with their plain versions (the W8A16 matmuls' and
    the LoRA kernel's too): the prompt as one prefill chunk, then one decode
    step per later token; with ``adapters``, through the request's tenant,
    pinned for the run.  Returns both routes' logits, ``[T, V]`` f32: row
    ``t`` predicts token ``t + 1``."""
    from accelerate_tpu_torch.models.llama import init_paged_cache
    from accelerate_tpu_torch.ops import lora as lora_mod

    dev = model.device
    tokens = list(request.prompt) + list(generated[:-1])
    p_len = request.prompt_len
    page = PLUGIN["page_size"]
    n_pages = -(-len(tokens) // page)
    ids = torch.tensor(tokens, device=dev)[None]
    pos = torch.arange(len(tokens), device=dev)[None]
    lora_kw = {}
    if adapters is not None:
        slot, _ = adapters.pin(request.adapter_id)
        lora_kw = dict(adapter_ids=torch.tensor([slot], device=dev), lora=adapters.pool)

    def run():
        cache = init_paged_cache(model.config, n_pages, page, 1, n_pages, kv_dtype=kv_dtype,
                                 device=dev)
        bt = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
        layers = [{**l, "block_tables": bt} for l in cache["layers"]]
        out = []
        with torch.inference_mode():
            for a, b in [(0, p_len)] + [(t, t + 1) for t in range(p_len, len(tokens))]:
                lg, layers = model(ids[:, a:b], positions=pos[:, a:b], cache=layers,
                                   cache_write_mask=torch.ones(1, b - a, dtype=torch.bool,
                                                               device=dev), **lora_kw)
                out.append(lg[0])
        return torch.cat(out)

    k_logits = run()
    with routed_attention(llama_mod, fa.paged_decode_attention_plain,
                          fa.paged_multitoken_attention_plain), \
            routed_qmm(qmm, qmm.quantized_matmul_plain, qmm.quantized_matmul_wholef_plain), \
            routed_bgmv(lora_mod, lora_mod.bgmv_apply_plain):
        p_logits = run()
    if adapters is not None:
        adapters.unpin(request.adapter_id)
    return k_logits, p_logits


def teacher_forced_check(torch, model, llama_mod, fa, qmm, request, generated,
                         kv_dtype="bf16", adapters=None) -> dict:
    """:func:`teacher_forced_logits` of the request's served tokens; every
    position's logits compared between the two routes."""
    k_logits, p_logits = teacher_forced_logits(torch, model, llama_mod, fa, qmm, request,
                                               generated, kv_dtype, adapters)
    tokens = list(request.prompt) + list(generated[:-1])
    p_len = request.prompt_len
    if k_logits.shape != (len(tokens), model.config.vocab_size):
        raise AssertionError(f"teacher-forced logits of shape {tuple(k_logits.shape)}")
    if not (torch.isfinite(k_logits).all() and torch.isfinite(p_logits).all()):
        raise AssertionError("non-finite logits in the teacher-forced run")
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean().item()
    rel = ((k_logits - p_logits).abs().mean() / p_logits.abs().mean()).item()
    # the kernel path's greedy continuation of the prompt against what the
    # engine served (reported, not gated: the engine ran bucket-padded
    # prefill chunks, so the matrix products saw other shapes)
    served = (k_logits[p_len - 1:].argmax(-1).tolist() == list(generated))
    rep = {"uid": request.uid, "adapter_id": request.adapter_id,
           "positions": len(tokens), "argmax_agreement": agree,
           "mean_abs_dlogit_over_mean_abs_logit": rel, "kernel_argmax_equals_served": served}
    if agree < 0.98 or rel > 1e-2:
        raise AssertionError(f"teacher-forced check failed: {rep}")
    return rep


def launch_counts() -> dict:
    """Every serving kernel wrapper's launch count."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import lora as lora_mod
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    return {name: getattr(mod, name).launches for mod, name in (
        (fa, "flash_fwd"), (fa, "flash_dq"), (fa, "flash_dkv"),
        (fa, "paged_decode_attention"), (fa, "paged_multitoken_attention"),
        (fa, "paged_decode_attention_quant"), (fa, "paged_multitoken_attention_quant"),
        (fa, "fused_bgmv_paged_decode"), (fa, "fused_bgmv_paged_decode_quant"),
        (qmm, "quantized_matmul_tiled"), (qmm, "quantized_matmul_wholef"),
        (lora_mod, "bgmv_apply"), (lora_mod, "bgmv"))}


def reset_counts() -> None:
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import lora as lora_mod
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    fa.reset_launch_counts()
    qmm.reset_launch_counts()
    lora_mod.reset_launch_counts()


def serve_once(torch, model, trace, kv_dtype="bf16", adapters=None, plugin=PLUGIN,
               draft_model=None, engine=None) -> tuple:
    """A fresh engine warmed up (with ``adapters``, a fresh store; or
    ``engine``, warm already) serving ``trace`` with every launch count
    zeroed first; every request must finish with its ``max_new_tokens``
    and the serving resource contract hold (``verify_serving_invariants``:
    page mirror, slots, adapter and prefix refcounts).  Per tick kind
    ("verify", "decode", "prefill"): the host wall of each tick (it ends in
    the tick's token fetch) and the kernel-wrapper launches.  Returns
    ``(engine, report, launches, ticks)``; the report is ``replay``'s."""
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin, replay

    if engine is None:
        engine = ServingEngine(model, ServingPlugin(**plugin, kv_dtype=kv_dtype),
                               GenerationConfig(max_new_tokens=MAX_NEW), device=model.device,
                               adapters=adapters, draft_model=draft_model)
        engine.warmup()
    ticks: dict = {}
    step = engine.step

    def timed_step():
        before = launch_counts()
        t0 = time.perf_counter()
        event = step()
        wall = time.perf_counter() - t0
        after = launch_counts()
        rec = ticks.setdefault(event["type"], {"ticks": 0, "host_s": 0.0, "launches": 0})
        rec["ticks"] += 1
        rec["host_s"] += wall
        rec["launches"] += sum(after.values()) - sum(before.values())
        return event

    reset_counts()
    engine.step = timed_step
    try:
        report = replay(engine, trace)
    finally:
        del engine.step
    launches = launch_counts()
    for r in trace:
        if len(engine.results.get(r.uid, ())) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(engine.results.get(r.uid, ()))} "
                                 f"tokens, expected {r.max_new_tokens}")
    from accelerate_tpu_torch.serving import verify_serving_invariants

    problems = verify_serving_invariants(engine)
    if problems:
        raise AssertionError(f"serving invariants after the serve: {problems}")
    per_tick = {kind: {"ticks": v["ticks"], "host_ms_per_tick": 1e3 * v["host_s"] / v["ticks"],
                       "kernel_launches_per_tick": v["launches"] / v["ticks"]}
                for kind, v in ticks.items()}
    return engine, report, launches, per_tick


def expect_launches(launches: dict, want: dict) -> None:
    """Every kernel launched exactly as the path says (kernels ``want``
    does not name: never), and each kernel ``want`` names at least once."""
    for name, count in launches.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{name} launched {count} times, expected {want.get(name, 0)}")
    for name, count in want.items():
        if count == 0:
            raise AssertionError(f"{name}: a kernel of the path never launched")


def engine_phase(torch, card: str, device: str = "cuda") -> dict:
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, synthesize_trace
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    trace = synthesize_trace(0, N_REQUESTS, **TRACE)
    engine, report, launches, _ = serve_once(torch, model, trace)
    setup_s = time.perf_counter() - t0 - report["wall_s"]
    m = engine.metrics
    layers = cfg.num_hidden_layers
    expect_launches(launches, {"paged_decode_attention": m["decode_steps"] * layers,
                               "paged_multitoken_attention": m["prefill_steps"] * layers})
    log("engine", json.dumps({"card": card, "params": n_params, "setup_s": setup_s,
                              **report, "launches": launches}))
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace)
    log("in_path", json.dumps(in_path))
    checks = [teacher_forced_check(torch, model, llama_mod, fa, qmm, trace[i],
                                   engine.results[trace[i].uid]) for i in (0, 1)]
    log("teacher_forced", json.dumps(checks))
    log(f"serving on {card}: {report['tokens_per_sec']:.1f} tokens/s, "
        f"TTFT p50 {report['ttft_p50_ms']:.2f} ms, token latency p50 "
        f"{report['p50_token_latency_ms']:.3f} ms / p99 {report['p99_token_latency_ms']:.3f} ms")
    return {"decode": launches["paged_decode_attention"],
            "prefill": launches["paged_multitoken_attention"], "in_path": in_path,
            "report": report, "results": dict(engine.results), "trace": trace, "model": model,
            "weight_bytes": sum(t.numel() * t.element_size() for t in model.state_dict().values())}


# -- speculative decode and the prefix cache ----------------------------------


def token_rule(torch, model, llama_mod, fa, qmm, trace, ref: dict, got: dict,
               kv_dtype="bf16", label="") -> dict:
    """Each request's tokens against the reference run's: equal, or first
    different at an index ``i`` where the reference's token and the other
    run's are a near-tie.  Near-tie: the reference sequence teacher-forced
    through the kernel route and the plain route; at ``i`` the gap between
    the two tokens' logits (kernel route) is no larger than the largest
    |logit difference| between the routes at that position.  Prints every
    divergence; raises on one that is not so explained."""
    equal, divergences = 0, []
    for r in trace:
        a, b = list(ref[r.uid]), list(got[r.uid])
        if a == b:
            equal += 1
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            raise AssertionError(f"{label} request {r.uid}: {len(b)} tokens, reference {len(a)}")
        # the reference teacher-forced up to its token i (row p_len - 1 + i)
        k_logits, p_logits = teacher_forced_logits(torch, model, llama_mod, fa, qmm, r,
                                                   a[:i + 1], kv_dtype=kv_dtype)
        row = r.prompt_len - 1 + i
        gap = abs(k_logits[row, a[i]] - k_logits[row, b[i]]).item()
        dlogit = (k_logits[row] - p_logits[row]).abs().max().item()
        div = {"uid": r.uid, "index": i, "reference_token": a[i], "token": b[i],
               "logit_gap": gap, "max_abs_dlogit_kernel_vs_plain": dlogit,
               "near_tie": gap <= dlogit}
        log(f"token_rule {label}", json.dumps(div))
        if not div["near_tie"]:
            raise AssertionError(f"{label}: request {r.uid} diverges at token {i} without a "
                                 f"near-tie: {div}")
        divergences.append(div)
    return {"requests": len(trace), "equal": equal, "divergences": divergences}


SPEC_KEYS = ("tokens_per_sec", "tokens_per_step", "tokens_per_step_predicted", "accept_rate",
             "accept_rate_predicted", "verify_steps", "drafted_tokens", "accepted_draft_tokens",
             "speculative_rollbacks", "draft_overhead_frac", "ttft_p50_ms",
             "p50_token_latency_ms", "p99_token_latency_ms", "evictions")


def speculate_phase(torch, card: str, bf16: dict) -> dict:
    """``bench.py --serve --speculate 4`` on the 600m model: the bf16
    serve's trace with prompt-lookup drafting, k 4.  Every verify pass is
    kernel #6 at [16, 5]; tokens against the bf16 serve's greedy tokens
    under the token rule; a checked rerun holds every launch (prefill
    windows and verify passes) against its plain version.  If the trace
    accepts no draft, 8 requests repeating a 5-token cycle serve too.  Then
    a draft-model serve (a 2-layer model at the 600m widths): #1 at T 32
    on every draft token, each launch held to its plain version."""
    import dataclasses

    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, Request
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    model, trace = bf16["model"], bf16["trace"]
    layers = model.config.num_hidden_layers
    plugin = {**PLUGIN, **SPEC}
    engine, report, launches, ticks = serve_once(torch, model, trace, plugin=plugin)
    m = engine.metrics
    expect_launches(launches, {"paged_multitoken_attention":
                               (m["verify_steps"] + m["prefill_steps"]) * layers})
    PATH_LAUNCHES["speculate"] = launches
    rule = token_rule(torch, model, llama_mod, fa, qmm, trace, bf16["results"], engine.results,
                      label="speculate")
    rep = {"card": card, **SPEC, "trace": "synthesize_trace(0, 16)",
           **{k: report[k] for k in SPEC_KEYS}, "launches": launches, "ticks": ticks,
           "greedy_tokens_per_sec": bf16["report"]["tokens_per_sec"], "token_rule": rule}
    log("speculate", json.dumps(rep))
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace, plugin=plugin,
                            required=["paged_multitoken_attention"], invariants=True)
    log("speculate_in_path", json.dumps(in_path))
    accepted = {"synthesize_trace(0, 16)": report["accepted_draft_tokens"]}
    if not report["accepted_draft_tokens"]:
        # prompt lookup finds the cycle; the model's greedy continuation
        # decides whether the drafts are accepted
        rng = np.random.default_rng(CYCLE)
        cyc_trace = []
        for uid in range(CYCLE_REQUESTS):
            cyc = [int(x) for x in rng.integers(1, MODEL["vocab_size"], CYCLE)]
            cyc_trace.append(Request(uid=uid, prompt=tuple((cyc * 64)[:128]), max_new_tokens=64))
        ref, _, _, _ = serve_once(torch, model, cyc_trace, plugin=PLUGIN)
        eng_c, rep_c, launches_c, ticks_c = serve_once(torch, model, cyc_trace, plugin=plugin)
        rule_c = token_rule(torch, model, llama_mod, fa, qmm, cyc_trace, ref.results,
                            eng_c.results, label="speculate cycle")
        accepted[f"{CYCLE_REQUESTS} prompts of a {CYCLE}-token cycle"] = \
            rep_c["accepted_draft_tokens"]
        log("speculate_cycle", json.dumps({**{k: rep_c[k] for k in SPEC_KEYS},
                                           "launches": launches_c, "ticks": ticks_c,
                                           "token_rule": rule_c}))
    if not any(accepted.values()):
        raise AssertionError(f"no draft token accepted on any trace: {accepted}")
    # the draft model: kernel #1 at the draft window
    draft_cfg = LlamaConfig(**{**MODEL, "num_hidden_layers": DRAFT_LAYERS}, dtype=torch.bfloat16)
    draft = LlamaForCausalLM(draft_cfg, device=model.device, seed=1)
    d_trace = [dataclasses.replace(r, max_new_tokens=DRAFT_NEW) for r in trace[:DRAFT_REQUESTS]]
    d_plugin = {**PLUGIN, "speculate": "draft", "speculate_k": SPEC["speculate_k"]}
    eng_d, rep_d, launches_d, ticks_d = serve_once(torch, model, d_trace, plugin=d_plugin,
                                                    draft_model=draft)
    k = SPEC["speculate_k"]
    passes = eng_d.metrics["verify_steps"]
    expect_launches(launches_d, {
        "paged_multitoken_attention": (passes + eng_d.metrics["prefill_steps"]) * layers,
        "flash_fwd": passes * k * DRAFT_LAYERS})
    PATH_LAUNCHES["speculate_draft"] = launches_d
    ref_d = {r.uid: bf16["results"][r.uid][:DRAFT_NEW] for r in d_trace}
    rule_d = token_rule(torch, model, llama_mod, fa, qmm, d_trace, ref_d, eng_d.results,
                        label="speculate draft")
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        in_path_d = in_path_check(torch, model, llama_mod, fa, qmm, d_trace, plugin=d_plugin,
                                  required=["paged_multitoken_attention"], draft_model=draft)
    in_path_d.update(worst_readings(readings, ["flash_fwd"]))
    rep_d = {"card": card, "draft_layers": DRAFT_LAYERS, "window": 32, "requests": len(d_trace),
             **{k2: rep_d[k2] for k2 in SPEC_KEYS}, "launches": launches_d, "ticks": ticks_d,
             "token_rule": rule_d, "in_path": in_path_d}
    log("speculate_draft", json.dumps(rep_d))
    log(f"speculative serving on {card}: {report['tokens_per_sec']:.1f} tokens/s (greedy "
        f"{bf16['report']['tokens_per_sec']:.1f}), {report['tokens_per_step']} tokens a step, "
        f"accept rate {report['accept_rate']} (predicted {report['accept_rate_predicted']}), "
        f"{report['verify_steps']} verify passes, {report['speculative_rollbacks']} pages "
        f"rolled back; {rule['equal']} of {rule['requests']} requests equal greedy")
    return {"launches": launches, "in_path": in_path, "draft_in_path": in_path_d,
            "report": rep}


def prefix_phase(torch, card: str, bf16: dict, quant_model) -> dict:
    """``bench.py --serve --prefix-share 0.5`` (plus ``--speculate 4``):
    the trace ``synthesize_trace(0, 16, prefix_share=0.5)`` served with both
    features off, then with the prefix cache and speculation on: tokens
    under the token rule; the hit rate beside its prediction, shared pages,
    forks, skipped prefill, TTFT off and on.  A checked rerun holds every
    launch against its plain version and checks the page mirror, refcounts
    and free stack after every tick.  Then the int8 model from int8 pages
    on the first 4 requests the same way (#7 at [16, 5], #11 at m 80)."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import synthesize_trace
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    model = bf16["model"]
    layers = model.config.num_hidden_layers
    trace = synthesize_trace(0, N_REQUESTS, **TRACE, prefix_share=PREFIX_SHARE)
    on = {**PLUGIN, **SPEC, "prefix_cache": "on"}
    off_eng, off_rep, _, _ = serve_once(torch, model, trace, plugin=PLUGIN)
    engine, report, launches, ticks = serve_once(torch, model, trace, plugin=on)
    m = engine.metrics
    expect_launches(launches, {"paged_multitoken_attention":
                               (m["verify_steps"] + m["prefill_steps"]) * layers})
    PATH_LAUNCHES["prefix"] = launches
    rule = token_rule(torch, model, llama_mod, fa, qmm, trace, off_eng.results, engine.results,
                      label="prefix")
    keys = ("prefix_hit_rate", "prefix_hit_rate_predicted", "pages_shared_peak", "cow_forks",
            "prefill_tokens_skipped", "prefix_evictions", "ttft_p50_ms", "ttft_p50_ticks",
            "tokens_per_sec", "accept_rate", "verify_steps", "accepted_draft_tokens",
            "speculative_rollbacks", "p50_token_latency_ms")
    rep = {"card": card, "prefix_share": PREFIX_SHARE, **SPEC, "on": {k: report[k] for k in keys},
           "off": {k: off_rep[k] for k in ("ttft_p50_ms", "ttft_p50_ticks", "tokens_per_sec",
                                           "p50_token_latency_ms")},
           "launches": launches, "ticks": ticks, "token_rule": rule}
    if not report["prefill_tokens_skipped"]:
        # every admission raced its preamble's first prefill: serve the
        # trace's first PREFIX_QUANT_REQUESTS again on the same engine, whose index
        # now holds the preambles, so prefill starts from adopted pages
        import dataclasses

        again = [dataclasses.replace(r, uid=r.uid + 1000, arrival_step=engine.steps)
                 for r in trace[:PREFIX_QUANT_REQUESTS]]
        _, rep_again, _, _ = serve_once(torch, model, again, plugin=on, engine=engine)
        rep["served_again"] = {k: rep_again[k] for k in ("prefix_hit_rate",
                                                         "prefill_tokens_skipped")}
        rule_again = token_rule(torch, model, llama_mod, fa, qmm, again,
                                {r.uid: off_eng.results[r.uid - 1000] for r in again},
                                engine.results, label="prefix served again")
        rep["served_again"]["token_rule"] = rule_again
        if not rep_again["prefill_tokens_skipped"]:
            raise AssertionError("no prefill started from an adopted prefix")
    log("prefix", json.dumps(rep))
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace, plugin=on,
                            required=["paged_multitoken_attention"], invariants=True)
    log("prefix_in_path", json.dumps(in_path))
    # int8 weights, int8 pages: #7 at the verify width, #11 at m 16 * 5
    q_trace = trace[:PREFIX_QUANT_REQUESTS]
    q_off, _, _, _ = serve_once(torch, quant_model, q_trace, plugin=PLUGIN, kv_dtype=QUANT_KV)
    q_eng, q_rep, q_launches, q_ticks = serve_once(torch, quant_model, q_trace, plugin=on,
                                                    kv_dtype=QUANT_KV)
    qm = q_eng.metrics
    expect_launches(q_launches, {
        "paged_multitoken_attention_quant": (qm["verify_steps"] + qm["prefill_steps"]) * layers,
        "quantized_matmul_tiled": 7 * layers * (qm["verify_steps"] + qm["prefill_steps"])})
    PATH_LAUNCHES["prefix_int8"] = q_launches
    q_rule = token_rule(torch, quant_model, llama_mod, fa, qmm, q_trace, q_off.results,
                        q_eng.results, kv_dtype=QUANT_KV, label="prefix int8")
    q_in_path = in_path_check(torch, quant_model, llama_mod, fa, qmm, q_trace, kv_dtype=QUANT_KV,
                              plugin=on, invariants=True,
                              required=["paged_multitoken_attention", "quantized_matmul_tiled"])
    q_rep = {"card": card, "kv_dtype": QUANT_KV, "weights": "int8 (W8A16)",
             "requests": len(q_trace), **{k: q_rep[k] for k in keys}, "launches": q_launches,
             "ticks": q_ticks, "token_rule": q_rule, "in_path": q_in_path}
    log("prefix_int8", json.dumps(q_rep))
    log(f"prefix-cache serving on {card}: hit rate {report['prefix_hit_rate']} (predicted "
        f"{report['prefix_hit_rate_predicted']}), {report['prefill_tokens_skipped']} prefill "
        f"tokens skipped, {report['pages_shared_peak']} pages shared at peak, "
        f"{report['cow_forks']} forks; TTFT p50 {report['ttft_p50_ms']:.2f} ms (off "
        f"{off_rep['ttft_p50_ms']:.2f}); {report['tokens_per_sec']:.1f} tokens/s (off "
        f"{off_rep['tokens_per_sec']:.1f}); {rule['equal']} of {rule['requests']} requests equal")
    return {"in_path": in_path, "quant_in_path": q_in_path, "report": rep, "quant": q_rep,
            "trace": trace, "off_results": dict(off_eng.results)}


# -- overload, the disaggregated pair, the fleet -------------------------------


def ttft_p50_ms(engines) -> float:
    samples = [t for eng in engines for t in eng.ttft_s]
    return float(np.percentile(samples, 50)) * 1e3 if samples else 0.0


def overload_phase(torch, card: str, bf16: dict) -> dict:
    """The speculative bf16 engine under overload: 32 requests of the
    bench trace with ``OVERLOAD``'s bounded queue, KV-pressure watermark
    and default deadline, through ``chaos_replay`` under the seeded
    ``STORM`` of cancels and a deadline storm; the ladder escalated at
    ``LADDER_TICKS`` and by the storm's deadline event through all four
    stages (#4 after despeculate, #6 at the smallest prefill bucket after
    shrink_prefill).  Shed, deadline miss and cancel must each occur.  The
    survivors' tokens are held to a fault-free serve of the survivors by
    the token rule; a checked rerun of the storm holds every #4 / #6 launch
    to its plain version and the resource contract after every tick.  SLO
    quantiles of the run are reported, not gated (host clocks)."""
    import dataclasses

    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin, synthesize_trace
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.resilience import FaultPlan
    from accelerate_tpu_torch.serving import chaos_replay, verify_serving_invariants
    from accelerate_tpu_torch.serving.harness import _overload_fields
    from accelerate_tpu_torch.telemetry import SLOMonitor, twin_registry

    model = bf16["model"]
    layers = model.config.num_hidden_layers
    trace = synthesize_trace(0, OVERLOAD_REQUESTS,
                             **dict(TRACE, new_tokens_range=OVERLOAD_NEW))
    plugin = ServingPlugin(**PLUGIN, **SPEC, **OVERLOAD)

    def new_engine():
        return ServingEngine(model, plugin, GenerationConfig(max_new_tokens=OVERLOAD_NEW[1]),
                             device=model.device)

    def storm():
        return FaultPlan.from_seed(STORM["seed"], STORM["n_steps"], p_cancel=STORM["p_cancel"],
                                   p_deadline=STORM["p_deadline"], serving=True)

    def escalate_at_fixed_ticks(engine):
        if engine.steps in LADDER_TICKS:
            engine.ladder.escalate()

    def ticking(engine, per_tick):
        # ``engine`` with ``per_tick(engine)`` run after each of its ticks
        step = engine.step

        def ticked():
            event = step()
            per_tick(engine)
            return event

        engine.step = ticked
        return engine

    lives, by_stage, last = [], {}, {}
    warm = new_engine()
    warm.warmup()

    def factory():
        eng = warm if not lives else new_engine()
        lives.append(eng)
        return ticking(eng, on_tick)

    def on_tick(engine):
        counts = launch_counts()
        row = by_stage.setdefault(engine.ladder.stage, {"ticks": 0, "paged_decode_attention": 0,
                                                        "paged_multitoken_attention": 0})
        row["ticks"] += 1
        for name in ("paged_decode_attention", "paged_multitoken_attention"):
            row[name] += counts[name] - last.get(name, 0)
        last.update(counts)
        escalate_at_fixed_ticks(engine)

    plan = storm()
    reset_counts()
    t0 = time.perf_counter()
    rep = chaos_replay(factory, trace, plan, baseline_parity=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    metrics = {k: sum(eng.metrics[k] for eng in lives)
               for k in ("decode_steps", "verify_steps", "prefill_steps", "generated_tokens")}
    expect_launches(launches, {
        "paged_decode_attention": metrics["decode_steps"] * layers,
        "paged_multitoken_attention": (metrics["verify_steps"] + metrics["prefill_steps"]) * layers})
    PATH_LAUNCHES["overload"] = launches
    stages = [stage for life in rep["ladder_stages"] for stage in life]
    for stage in ("despeculate", "shrink_prefill", "tighten_admission", "shed"):
        if stage not in stages:
            raise AssertionError(f"the ladder never reached {stage}: {stages}")
    for key in ("requests_shed", "deadline_misses", "cancelled"):
        if not rep[key]:
            raise AssertionError(f"overload: no {key} on the storm: {rep}")
    if not by_stage.get("despeculate", {}).get("paged_decode_attention") or \
            not by_stage.get("shrink_prefill", {}).get("paged_multitoken_attention"):
        raise AssertionError(f"no #4 after despeculate or no shrunk prefill: {by_stage}")
    # the survivors, fault-free, deadlines dropped, knobs disarmed
    survivors = [dataclasses.replace(r, arrival_step=0, deadline_ticks=0)
                 for r in sorted(trace, key=lambda r: r.uid) if r.uid in rep["results"]]
    base, _, _, _ = serve_once(torch, model, survivors, plugin={**PLUGIN, **SPEC})
    rule = token_rule(torch, model, llama_mod, fa, qmm, survivors, base.results, rep["results"],
                      label="overload")
    # each serving.* twin's measured side (recorded here) beside the
    # clean-run model's prediction, which a storm departs from on purpose
    fields = _overload_fields(lives[-1], trace)
    twins = {name: {"measured": twin_registry().get(f"serving.{name}").measured,
                    "clean_run_model": 1.0 if name == "request_goodput_frac" else 0}
             for name in ("requests_shed", "deadline_misses", "cancelled",
                          "pages_reclaimed_on_cancel", "request_goodput_frac")}
    slo = SLOMonitor({"token_latency_s": {"p99_trip": 0.1}, "ttft_s": {"p99_trip": 5.0}})
    for eng in lives:
        slo.observe_many("token_latency_s", eng.token_gaps_s)
        slo.observe_many("ttft_s", eng.ttft_s)
    # the checked rerun: the same storm and escalations, every #4 / #6
    # launch against its plain version, the resource contract every tick
    readings, checked_ticks = {}, [0]

    def on_tick_checked(engine):
        problems = verify_serving_invariants(engine)
        if problems:
            raise AssertionError(f"overload tick {engine.steps}: {problems}")
        checked_ticks[0] += 1
        escalate_at_fixed_ticks(engine)

    with checked_kernels(torch, llama_mod, fa, qmm, readings):
        rep_checked = chaos_replay(lambda: ticking(new_engine(), on_tick_checked), trace,
                                   storm(), baseline_parity=False)
    if rep_checked["results"] != rep["results"]:
        raise AssertionError("overload: the checked rerun's survivors or tokens differ from "
                             "the timed run's")
    in_path = worst_readings(readings, ["paged_decode_attention", "paged_multitoken_attention"])
    in_path["invariants_checked_ticks"] = checked_ticks[0]
    out = {"card": card, "requests": len(trace), **OVERLOAD, "storm": STORM,
           "ladder_ticks": list(LADDER_TICKS), "storm_events": [
               (e.kind, e.at) for e in plan.events], "faults_fired": rep["faults_fired"],
           "tokens_per_sec": metrics["generated_tokens"] / wall, "wall_s": wall,
           "ttft_p50_ms": ttft_p50_ms(lives), "completed": rep["completed"],
           "restarts": rep["restarts"],
           **{k: rep[k] for k in ("requests_shed", "deadline_misses", "cancelled",
                                  "pages_reclaimed_on_cancel")},
           "request_goodput_frac": fields["request_goodput_frac"], "twins": twins,
           "ladder_stages": rep["ladder_stages"], "by_stage": by_stage,
           "launches": launches, "token_rule": rule,
           "slo": slo.report(), "in_path": in_path}
    log("overload", json.dumps(out))
    log(f"overload on {card}: {out['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms; shed {rep['requests_shed']}, deadline misses "
        f"{rep['deadline_misses']}, cancelled {rep['cancelled']}, pages reclaimed "
        f"{rep['pages_reclaimed_on_cancel']}, goodput {fields['request_goodput_frac']}; "
        f"{rule['equal']} of {rule['requests']} survivors equal the fault-free serve")
    return {"in_path": in_path, "report": out}


def serve_pair(torch, model, trace, kv_dtype="bf16", timed=False, invariants=False) -> tuple:
    """A fresh ``DisaggregatedPair`` over ``model`` (PLUGIN's geometry,
    ``kv_dtype`` pages), warmed, launch counts zeroed, driven tick by tick
    over ``trace``; with ``timed`` each ``send`` / ``recv`` of the
    transport is bracketed by CUDA events, with ``invariants`` the resource
    contract of both engines is checked after every tick.  Returns ``(pair,
    wall_s, launches (timed runs), transfer events, ticks)``."""
    from accelerate_tpu_torch import GenerationConfig, ServingPlugin
    from accelerate_tpu_torch.serving import DisaggregatedPair, verify_serving_invariants

    pair = DisaggregatedPair(model, ServingPlugin(**PLUGIN, kv_dtype=kv_dtype),
                             GenerationConfig(max_new_tokens=MAX_NEW), device=model.device)
    pair.warmup()
    events = []
    if timed:
        t = pair.transport
        send, recv = t.send, t.recv

        def bracketed(fn, kind):
            def call(*args):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args)
                end.record()
                # the live page count; no payload kept alive
                events.append((kind, start, end, args[2] if kind == "recv" else args[1]))
                return out
            return call

        t.send, t.recv = bracketed(send, "send"), bracketed(recv, "recv")
    reset_counts()
    ticks = 0
    t0 = time.perf_counter()
    for r in trace:
        pair.submit(r)
    while pair.tick():
        ticks += 1
        if invariants:
            for eng in (pair.prefill_engine, pair.decode_engine):
                problems = verify_serving_invariants(eng)
                if problems:
                    raise AssertionError(f"pair tick {ticks}: {problems}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if timed:
        del pair.transport.send, pair.transport.recv
    missing = [r.uid for r in trace if len(pair.results.get(r.uid, ())) != r.max_new_tokens]
    if missing:
        raise AssertionError(f"pair: requests {missing} did not finish")
    # the checked rerun's routed wrappers carry no counts: read them on the
    # main run only
    return pair, wall, launch_counts() if timed else None, events, ticks


def transfer_times(events, page_bytes: int) -> dict:
    """Per slot: the mean ms of the transport's gather (``send``) and
    scatter (``recv``) beside their bounds: read plus write of the live
    pages each moves (``n_pages * page_bytes``) over 3.35 TB/s."""
    send = [(s.elapsed_time(e), n) for kind, s, e, n in events if kind == "send"]
    recv = [(s.elapsed_time(e), n) for kind, s, e, n in events if kind == "recv"]
    count = max(len(send), 1)

    def bound_ms(calls):
        return sum(2 * n * page_bytes / HBM_BYTES_PER_S * 1e3 for _, n in calls) / count

    send_ms, recv_ms = (sum(t for t, _ in calls) / count for calls in (send, recv))
    return {"transfers": len(send), "page_bytes": page_bytes,
            "live_pages_mean": sum(n for _, n in send) / count,
            "send_ms": send_ms, "send_bound_ms": bound_ms(send),
            "recv_ms": recv_ms, "recv_bound_ms": bound_ms(recv),
            "slot_ms": send_ms + recv_ms, "slot_bound_ms": bound_ms(send) + bound_ms(recv)}


def transfer_probe(torch, pair, n_pages: int, reps: int = 5) -> dict:
    """Where a transfer's time goes, after a timed pair run (the pair is
    not served again): the gather of the prefill engine's slot 0 over its
    whole block-table row (JAX's ``pps``-wide wire shape) beside the
    gather of its first ``n_pages`` pages, each the mean of ``reps``
    CUDA-event times; then the live gather and a scatter into the idle
    decode engine's slot 0, each once more under ``torch.profiler``: the
    summed time of the device kernels each runs, beside its event time.
    What the event time holds beyond the kernels is the card waiting on
    the host (launches, the scatter's allocator sync)."""
    from torch.profiler import ProfilerActivity, profile

    t = pair.transport

    def event_ms(fn):
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sum(times) / reps

    payload = t.send(0, n_pages)
    calls = {"send_row": lambda: t.send(0), "send_live": lambda: t.send(0, n_pages),
             "recv_live": lambda: t.recv(0, payload, n_pages, n_pages)}
    out = {"n_pages": n_pages, "reps": reps}
    for name, fn in calls.items():
        out[f"{name}_ms"] = event_ms(fn)
    if torch.cuda.is_available():          # a CPU rehearsal has no device kernel
        for name in ("send_live", "recv_live"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                calls[name]()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if not kernels:
                raise AssertionError("torch.profiler saw no device kernel of the transport")
            out[f"{name}_kernels"] = len(kernels)
            out[f"{name}_kernel_ms"] = sum(
                e.time_range.end - e.time_range.start for e in kernels) / 1e3
    return out


def disaggregate_phase(torch, card: str, bf16: dict, quant: dict) -> dict:
    """``bench.py --serve --disaggregate``'s pair (``bench.py:587-609``),
    twice: the bf16 600m over the 16-request trace (#6 on the prefill
    engine, #4 on the decode engine), and the int8-weight model over int8
    pages on its first 4 requests (#7 / #11 prefill, #5 / #11 decode).
    Each: transfers, pages and bytes against ``transfer_accounting`` (equal),
    each slot's gather and scatter (CUDA events) against its bound, tokens/s
    beside the fused serve's, tokens under the token rule against the fused
    serve's; a checked rerun holds every kernel launch to its plain version
    with the resource contract of both engines after every tick."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.serving import transfer_accounting
    from accelerate_tpu_torch.telemetry import twin_registry

    layers = MODEL["num_hidden_layers"]
    out = {}
    for label, model, trace, kv, ref, fused_tps in (
            ("disaggregate", bf16["model"], bf16["trace"], "bf16", bf16["results"],
             bf16["report"]["tokens_per_sec"]),
            ("disaggregate_int8", quant["model"], bf16["trace"][:PAIR_INT8_REQUESTS], QUANT_KV,
             quant["results"], quant["report"]["tokens_per_sec"])):
        pair, wall, launches, events, ticks = serve_pair(torch, model, trace, kv, timed=True)
        P, D = pair.prefill_engine, pair.decode_engine
        prefill, decode = P.metrics["prefill_steps"], D.metrics["decode_steps"]
        if kv == "bf16":
            want = {"paged_multitoken_attention": prefill * layers,
                    "paged_decode_attention": decode * layers}
        else:
            want = {"paged_multitoken_attention_quant": prefill * layers,
                    "paged_decode_attention_quant": decode * layers,
                    "quantized_matmul_tiled": 7 * layers * (prefill + decode)}
        expect_launches(launches, want)
        PATH_LAUNCHES[label] = launches
        rep = pair.report()
        acc = transfer_accounting(model.config, trace, PLUGIN["page_size"], dtype_bytes=2,
                                  kv_dtype="" if kv == "bf16" else kv)
        if rep["page_transfer_bytes"] != acc["page_transfer_bytes"] or \
                rep["page_transfer_pages"] != acc["pages_predicted"]:
            raise AssertionError(f"{label}: transfer bytes {rep} vs accounting {acc}")
        twin = twin_registry().get("transfer.page_bytes")
        times = transfer_times(events, pair.transport.schema["page_bytes"])
        rule = token_rule(torch, model, llama_mod, fa, qmm, trace, ref, pair.results,
                          kv_dtype=kv, label=label)
        readings = {}
        with checked_kernels(torch, llama_mod, fa, qmm, readings):
            checked, _, _, _, checked_ticks = serve_pair(torch, model, trace, kv, invariants=True)
        required = ["paged_decode_attention", "paged_multitoken_attention"]
        if kv != "bf16":
            required.append("quantized_matmul_tiled")
        in_path = worst_readings(readings, required)
        in_path["invariants_checked_ticks"] = checked_ticks
        if checked.results != pair.results:
            raise AssertionError(f"{label}: the checked rerun's tokens differ from the timed "
                                 "run's")
        del checked
        probe = transfer_probe(torch, pair, round(times["live_pages_mean"]))
        gen = sum(len(v) for v in pair.results.values())
        out[label] = {"card": card, "kv_dtype": kv, "requests": len(trace), **rep,
                      "transfer_accounting": acc, "twin_rel_err": twin.rel_err,
                      "transfer": times, "transfer_probe": probe, "ticks": ticks,
                      "wall_s": wall,
                      "tokens_per_sec": gen / wall, "fused_tokens_per_sec": fused_tps,
                      "launches": launches, "token_rule": rule,
                      "in_path": in_path}
        log(label, json.dumps(out[label]))
        PAIR_REPORTS[label] = out[label]
        log(f"{label} on {card}: {rep['page_transfers']} transfers, {rep['page_transfer_pages']} "
            f"pages, {rep['page_transfer_bytes']} bytes (accounting "
            f"{acc['page_transfer_bytes']}); a slot's gather + scatter {times['slot_ms']:.4f} ms "
            f"(bound {times['slot_bound_ms']:.4f}; whole-row gather {probe['send_row_ms']:.4f} "
            f"ms against {probe['send_live_ms']:.4f} for {probe['n_pages']} live pages); "
            f"{gen / wall:.1f} tokens/s (fused "
            f"{fused_tps:.1f}); {rule['equal']} of {rule['requests']} requests equal the fused "
            f"serve")
    return out


def placements(router) -> list:
    """``(replica, uid)`` of every submit on each replica's engine."""
    return [(rep.index, ev[1]) for rep in router.replicas
            for ev in rep.backend.sched.events if ev[0] == "submit"]


def fleet_phase(torch, card: str, bf16: dict, prefix: dict) -> dict:
    """``bench.py --serve --fleet 2``'s router (``bench.py:610-640``) over
    two fused bf16 engines sharing the model, on the prefix-share trace
    with the prefix cache on: under ``affinity`` and under ``round_robin``
    (hit rate, routed-by counts, per-replica occupancy, tokens under the
    token rule against the fused serve with both features off), then a
    ``fleet_chaos_replay`` with a ``replica_kill`` at fleet tick
    ``FLEET_KILL_AT``: the drained requests re-route exactly once, the
    survivors meet the token rule, and the fault-free baseline's
    placements equal the first affinity run's."""
    from collections import Counter

    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.resilience import FaultEvent, FaultPlan
    from accelerate_tpu_torch.serving import FleetRouter, fleet_chaos_replay, fleet_replay

    model, trace, ref = bf16["model"], prefix["trace"], prefix["off_results"]
    layers = model.config.num_hidden_layers
    plugin = ServingPlugin(**PLUGIN, prefix_cache="on")
    routers = []

    def new_router(policy="affinity"):
        r = FleetRouter([ServingEngine(model, plugin, GenerationConfig(max_new_tokens=MAX_NEW),
                                       device=model.device) for _ in range(FLEET_REPLICAS)],
                        policy=policy)
        routers.append(r)
        return r

    def row(rep):
        return {k: v for k, v in rep.items() if k not in ("results", "per_replica")}

    out = {"card": card, "replicas": FLEET_REPLICAS, "requests": len(trace)}
    for policy in ("affinity", "round_robin"):
        router = new_router(policy)
        router.warmup()
        reset_counts()
        t0 = time.perf_counter()
        rep = fleet_replay(router, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        engines = [r.backend for r in router.replicas]
        expect_launches(launches, {
            "paged_decode_attention": sum(e.metrics["decode_steps"] for e in engines) * layers,
            "paged_multitoken_attention": sum(e.metrics["prefill_steps"]
                                              for e in engines) * layers})
        if policy == "affinity":
            PATH_LAUNCHES["fleet"] = launches
        rule = token_rule(torch, model, llama_mod, fa, qmm, trace, ref, rep["results"],
                          label=f"fleet {policy}")
        out[policy] = {**row(rep), "tokens_per_sec": sum(e.metrics["generated_tokens"]
                                                         for e in engines) / wall,
                       "per_replica": [{**r, "kv_pool_peak_utilization":
                                        e.metrics["peak_used_pages"] / PLUGIN["num_pages"]}
                                       for r, e in zip(rep["per_replica"], engines)],
                       "launches": launches, "token_rule": rule}
    first = placements(routers[0])
    chaos = fleet_chaos_replay(new_router, trace,
                               FaultPlan([FaultEvent("replica_kill", at=FLEET_KILL_AT)]))
    chaos_router, baseline = routers[-2], routers[-1]
    if placements(baseline) != first:
        raise AssertionError("fleet: the two fault-free affinity runs placed requests apart")
    drains = chaos["drain_events"]
    counts = Counter(uid for _, uid in placements(chaos_router))
    rerouted = sorted(uid for uid, n in counts.items() if n == 2)
    if len(drains) != 1 or any(n > 2 for n in counts.values()) or \
            len(rerouted) != drains[0]["survivors"] or set(counts) != {r.uid for r in trace} or \
            chaos["goodput_frac"] != 1.0:
        raise AssertionError(f"fleet: a drained request did not re-route exactly once: "
                             f"{drains} {dict(counts)}")
    rule = token_rule(torch, model, llama_mod, fa, qmm, trace, ref, chaos["results"],
                      label="fleet chaos")
    out["chaos"] = {**{k: v for k, v in chaos.items() if k not in ("results", "per_replica")},
                    "rerouted": rerouted, "bitwise_equal_to_baseline": chaos["token_parity"],
                    "token_rule": rule}
    out["placements_equal_across_affinity_runs"] = True
    log("fleet", json.dumps(out))
    aff, rr = out["affinity"], out["round_robin"]
    log(f"fleet on {card}: prefix hit rate affinity {aff['prefix_hit_rate']} / round robin "
        f"{rr['prefix_hit_rate']}; routed by prefix {aff['routed_by_prefix']}, adapter "
        f"{aff['routed_by_adapter']}, load {aff['routed_by_load']}; {aff['tokens_per_sec']:.1f} / "
        f"{rr['tokens_per_sec']:.1f} tokens/s; replica_kill at tick {FLEET_KILL_AT}: "
        f"{len(rerouted)} requests re-routed once, {rule['equal']} of {rule['requests']} equal")
    return out


# -- big-model inference: checkpoint -> card, tiers, streamed decode, beams ---

# the phase writes the bf16 serve's weights as HF shards, serves them loaded
# (bf16, then int8 on load), tiers them by a card budget of CARD_SHARE of
# the bf16 bytes and a host budget of CPU_LAYERS layers (the rest to disk),
# streams B x T prompts for NEW tokens, and beam-searches BEAM_B prompts
BIG = dict(shards=3, check_requests=4, batch=4, prompt=128, new=32, card_share=0.4,
           cpu_layers=6, beams=4, beam_batch=2, beam_new=32, copies=10)
# the streamed decode's peak device memory, above what the card held before
# it, must stay under: the embedding / norm / head it moves on +
# (prefetch_depth + 1) streamed layers + the KV cache + the f32 logits it
# captures + ACT_SLACK for the activations of a forward (a prefill at B x T
# holds ~2 MB a token before the head)
ACT_SLACK = 64 * 2**20
# a beam's length-normalised log-probability against greedy's, teacher-
# forced through one forward over prompt + tokens (other shapes than the
# decode's: bf16 roundings), nats a token
BEAM_SCORE_TOL = 1e-2


def write_hf_checkpoint(torch, model, folder: Path, shards: int) -> dict:
    """``model``'s state as HF safetensors: ``shards`` files of contiguous
    tensors, about equal in bytes, and ``model.safetensors.index.json``."""
    from accelerate_tpu_torch.utils.serialization import save_safetensors

    folder.mkdir(parents=True)
    t0 = time.perf_counter()
    state = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    d2h_s = time.perf_counter() - t0
    total = sum(t.numel() * t.element_size() for t in state.values())
    groups, acc = [[]], 0
    for name, t in state.items():
        if acc >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(name)
        acc += t.numel() * t.element_size()
    weight_map = {}
    t0 = time.perf_counter()
    for i, names in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        save_safetensors(folder / fname, {k: state[k] for k in names})
        weight_map.update({k: fname for k in names})
    (folder / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    write_s = time.perf_counter() - t0
    return {"bytes": total, "files": len(groups), "d2h_ms": 1e3 * d2h_s,
            "write_ms": 1e3 * write_s, "write_gb_s": total / write_s / 1e9}


def settled_allocated(torch) -> int:
    """Device bytes allocated once earlier phases' garbage is collected:
    the baseline of a peak that frees nothing of its own while measured."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def empty_llama(torch):
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, init_empty_weights

    with init_empty_weights():
        return LlamaForCausalLM(LlamaConfig(**MODEL, dtype=torch.bfloat16))


def held_equal(torch, got: dict, want: dict, label: str) -> None:
    """Every tensor of ``got`` bitwise ``want``'s, the same names."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: names differ: {sorted(set(got) ^ set(want))[:4]}")
    for k, v in got.items():
        if not torch.equal(v, want[k].to(v.device)):
            raise AssertionError(f"{label}: {k} differs")


def stall_recorder(torch, streaming):
    """Patch ``StagedTree.wait`` so each wait of the compute stream on a
    staged layer is bracketed by two CUDA events; returns the list of
    event pairs and the undo."""
    pairs, orig = [], streaming.StagedTree.wait

    def wait(self):
        if self.event is None:
            return orig(self)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(self)
        b.record()
        pairs.append((a, b))
        return out

    streaming.StagedTree.wait = wait
    return pairs, lambda: setattr(streaming.StagedTree, "wait", orig)


def bare_h2d_gb_s(torch, layer_tensors: dict, copies: int) -> float:
    """One pinned layer copied to the card ``copies`` times, CUDA events."""
    src = {k: t if t.is_pinned() else t.pin_memory() for k, t in layer_tensors.items()}
    dst = {k: torch.empty_like(t, device="cuda") for k, t in src.items()}
    nbytes = sum(t.numel() * t.element_size() for t in src.values())
    for k in src:
        dst[k].copy_(src[k], non_blocking=True)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(copies):
        for k in src:
            dst[k].copy_(src[k], non_blocking=True)
    b.record()
    torch.cuda.synchronize()
    return nbytes * copies / (a.elapsed_time(b) / 1e3) / 1e9


def streamed_case(torch, label, tiered, resident, ids, placement, store, budget) -> dict:
    """``generate_streamed`` on ``tiered`` (layers on the card, pinned
    host and disk by ``placement``) with prefetch on (timed, stats, stall
    events, peak memory, launch counts) and off, the disk tier swapped for
    pinned copies, and ``generate`` on ``resident``: tokens all equal,
    logits on / off bitwise."""
    from accelerate_tpu_torch import GenerationConfig, generate, generate_streamed
    from accelerate_tpu_torch.big_modeling import _named_tensors, compute_module_sizes
    from accelerate_tpu_torch.ops import streaming
    from accelerate_tpu_torch.ops.streaming import StreamStats, file_span, predicted_overlap

    b, new = ids.shape[0], BIG["new"]
    gc = GenerationConfig(max_new_tokens=new)
    layers = tiered.config.num_hidden_layers
    tensors = _named_tensors(tiered)
    sizes = compute_module_sizes(tiered)
    off_card = [i for i in range(layers) if placement.get(f"model.layers.{i}", 0) != 0]
    streamed_bytes = sum(sizes[f"model.layers.{i}"] for i in off_card)
    layer_bytes = max(sizes[f"model.layers.{i}"] for i in range(layers))

    def timed(fn):
        sync(torch)
        t0 = time.perf_counter()
        out = fn()
        sync(torch)
        return out, time.perf_counter() - t0

    generate_streamed(tiered, ids, GenerationConfig(max_new_tokens=2))     # warm-up
    want, resident_s = timed(lambda: generate(resident, ids, gc))
    pairs, undo = stall_recorder(torch, streaming)
    stats, on_logits = StreamStats(), []
    base = settled_allocated(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        on, on_s = timed(lambda: generate_streamed(tiered, ids, gc, stream_stats=stats,
                                                   capture_logits=on_logits))
    finally:
        undo()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    stall_s = sum(a.elapsed_time(b_) for a, b_ in pairs) / 1e3
    # each off-card layer once a forward, and layer 0 once more: the
    # lookahead wraps past the last forward's last layer
    want_h2d = new * streamed_bytes + (sizes["model.layers.0"] if 0 in off_card else 0)
    if stats.h2d_bytes != want_h2d:
        raise AssertionError(f"{label}: {stats.h2d_bytes} bytes streamed, the off-card "
                             f"layers hold {want_h2d}")
    off_logits = []
    off, off_s = timed(lambda: generate_streamed(tiered, ids, gc, prefetch=False,
                                                 capture_logits=off_logits))
    for i, (x, y) in enumerate(zip(on_logits, off_logits)):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: forward {i}'s logits differ with prefetch on / off")
    pinned = {k: tensors[k].clone().pin_memory() for k in store.keys()}
    pinned_tokens = generate_streamed(tiered, ids, gc, params=pinned)
    for name, got in (("prefetch off", off), ("disk as pinned", pinned_tokens),
                      ("generate", want)):
        if not torch.equal(on, got):
            raise AssertionError(f"{label}: streamed tokens differ from {name}'s")
    moved = sum(tensors[k].numel() * tensors[k].element_size()
                for k in ("model.embed_tokens.weight", "model.norm.weight", "lm_head.weight")
                if tensors[k].device.type != "cuda")
    cfg = tiered.config
    kv = layers * 2 * b * (ids.shape[1] + new) * cfg.num_key_value_heads * cfg.head_dim * 2 \
        + layers * b * (ids.shape[1] + new) * 4
    captured = sum(t.numel() * t.element_size() for t in on_logits)
    mem_bound = moved + 2 * layer_bytes + kv + captured + ACT_SLACK
    if peak > mem_bound:
        raise AssertionError(f"{label}: streamed peak {peak} B above its bound {mem_bound} B")
    copy_layer = {k[len(f"model.layers.{off_card[0]}."):]: t for k, t in tensors.items()
                  if k.startswith(f"model.layers.{off_card[0]}.")}
    gb_s = bare_h2d_gb_s(torch, copy_layer, BIG["copies"])
    staging_gb_s = staging_probe(torch, {k: t for k, t in tensors.items()
                                         if k.startswith("model.layers.")
                                         and file_span(t) is not None})
    per_forward = stats.h2d_bytes / new
    serial_s = per_forward / (gb_s * 1e9)
    compute_s = resident_s / new
    stall_per_forward = stall_s / new
    return {
        "label": label, "batch": b, "prompt": ids.shape[1], "new": new,
        "placement_layers": {t: sum(1 for i in range(layers)
                                    if placement.get(f"model.layers.{i}", 0) == t)
                             for t in (0, "cpu", "disk")},
        "budget": budget, "store_tensors": len(store.keys()),
        "tokens_per_s": {"prefetch": b * new / on_s, "serial": b * new / off_s,
                         "resident_generate": b * new / resident_s},
        "h2d_bytes_per_forward": per_forward, "streamed_layer_bytes": streamed_bytes,
        "layer_bytes_x_layers": layer_bytes * layers,
        "bare_pinned_h2d_gb_s": gb_s, "achieved_h2d_gb_s": stats.h2d_bytes / on_s / 1e9,
        "staging_gb_s": staging_gb_s,
        "fetches": stats.fetches, "prefetch_hits": stats.prefetch_hits,
        "fetch_wait_s_host": stats.fetch_wait_s,
        "device_stall_ms_per_forward": 1e3 * stall_per_forward,
        "serial_transfer_ms_per_forward": 1e3 * serial_s,
        "resident_ms_per_forward": 1e3 * compute_s,
        "overlap_frac": 1.0 - stall_per_forward / serial_s if serial_s else None,
        "predicted_overlap": predicted_overlap(serial_s, compute_s),
        "peak_bytes": peak, "peak_bound_bytes": mem_bound,
        "peak_bound_terms": {"moved_resident": moved, "layers_in_flight": 2 * layer_bytes,
                             "kv": kv, "captured_logits": captured, "slack": ACT_SLACK},
        "launches": launches, "bitwise": {"prefetch_off": True, "disk_as_pinned": True,
                                          "generate": True},
    }


def staging_probe(torch, disk: dict) -> dict:
    """GB/s of filling a pinned slot with every disk-tier layer tensor (what
    one forward stages), warm, by the two routes of ``PinnedStaging``: the
    copy through the memory maps (the streamed decode's) and the native
    engine's parallel ``pread`` of the files (``AlignDevicesHook``'s)."""
    from accelerate_tpu_torch.ops.streaming import PinnedStaging

    total = sum(t.numel() * t.element_size() for t in disk.values())
    out = {"bytes": total}
    for route, read_files in (("copy_through_map", False), ("pread", True)):
        staging = PinnedStaging(1, pin=True, read_files=read_files)
        staging.stage(disk)
        t0 = time.perf_counter()
        for _ in range(3):
            staging.stage(disk)
        out[route] = 3 * total / (time.perf_counter() - t0) / 1e9
    return out


def beam_case(torch, label, model, ids) -> dict:
    """``beam_search`` with 4 beams (timed, launches counted), 1 beam
    against ``generate``, and the best beams' length-normalised
    log-probabilities against greedy's."""
    from accelerate_tpu_torch import GenerationConfig, beam_search, generate

    gc = GenerationConfig(max_new_tokens=BIG["beam_new"])
    greedy = generate(model, ids, gc)
    if not torch.equal(beam_search(model, ids, gc, num_beams=1), greedy):
        raise AssertionError(f"beam {label}: one beam differs from greedy")
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    beams = beam_search(model, ids, gc, num_beams=BIG["beams"])
    sync(torch)
    wall = time.perf_counter() - t0
    launches = launch_counts()

    def score(tokens):
        seq = torch.cat([ids.long(), tokens.long()], dim=1)
        logp = torch.log_softmax(model(seq).float(), dim=-1)[:, ids.shape[1] - 1:-1]
        return (logp.gather(-1, tokens.long()[..., None])[..., 0].sum(-1)
                / tokens.shape[1]).tolist()

    beam_score, greedy_score = score(beams), score(greedy)
    if any(bs < gs - BEAM_SCORE_TOL for bs, gs in zip(beam_score, greedy_score)):
        raise AssertionError(f"beam {label}: best beam {beam_score} below greedy {greedy_score}")
    return {"label": label, "batch": ids.shape[0], "beams": BIG["beams"],
            "new": BIG["beam_new"], "tokens_per_s": ids.shape[0] * BIG["beam_new"] / wall,
            "beam_score_per_token": beam_score, "greedy_score_per_token": greedy_score,
            "one_beam_equals_greedy": True, "launches": launches}


def entry_points_case(torch, model, qref, folder: Path) -> dict:
    """The big-model entry points the phase's main path does not call, on
    the card at the 600m widths, each held to its resident or plain
    version: ``get_max_memory()`` against ``mem_get_info``;
    ``abstract_init`` + ``init_params_leafwise`` (two layers, layer 1 in
    pinned host memory, the card's generator) decoded by
    ``generate_streamed``, the tokens ``generate``'s on a resident copy;
    then one decoder layer, whose resident forward on a [B, T, H] input
    every other forward must equal bitwise: ``cpu_offload`` and
    ``disk_offload`` with ``offloaded_apply``, ``AlignDevicesHook`` over
    ``OffloadStore`` memory maps (read into its pinned slot) on a meta
    shell, ``offload=False`` over pinned weights, ``CpuOffloadHook``,
    ``offload_state_dict`` + ``offload_store_params`` through
    ``offloaded_apply``;
    ``layerwise_casting`` (fp8 storage) against the layer on its weights
    rounded through fp8; ``quantized_apply`` on the int8 model's layer
    against the layer on its dequantized weights."""
    import copy

    from accelerate_tpu_torch import (
        AlignDevicesHook, CpuOffloadHook, GenerationConfig, LlamaConfig, LlamaForCausalLM,
        abstract_init, add_hook_to_module, attach_align_device_hook, cpu_offload,
        disk_offload, generate, generate_streamed, get_max_memory, init_empty_weights,
        init_params_leafwise, layerwise_casting, offload_state_dict, offload_store_params,
        offloaded_apply, quantized_apply,
    )
    from accelerate_tpu_torch.big_modeling import OffloadStore, _named_tensors
    from accelerate_tpu_torch.ops.streaming import file_span
    from accelerate_tpu_torch.models.layers import QuantizableDense
    from accelerate_tpu_torch.models.llama import LlamaBlock
    from accelerate_tpu_torch.utils.quantization import dequantize

    out = {}
    free, total = torch.cuda.mem_get_info(0)
    budget = get_max_memory()
    if set(budget) != set(range(torch.cuda.device_count())) | {"cpu"} or budget["cpu"] <= 0 \
            or abs(budget[0] - 0.9 * free) > 0.01 * total:
        raise AssertionError(f"get_max_memory() {budget} against free {free} of {total}")
    out["get_max_memory"] = {"card": budget[0], "cpu": budget["cpu"], "free": free}

    cfg2 = LlamaConfig(**{**MODEL, "num_hidden_layers": 2}, dtype=torch.bfloat16)
    built = abstract_init(LlamaForCausalLM, cfg2)
    if any(p.device.type != "meta" for p in built.parameters()):
        raise AssertionError("abstract_init: a parameter off meta")
    init_params_leafwise(built, placement={"model.layers.1": "cpu"})
    for name, t in _named_tensors(built).items():
        host = name.startswith("model.layers.1.")
        if (t.device.type == "cpu") != host or (host and not t.is_pinned()) \
                or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"init_params_leafwise: {name} on {t.device}")
    std = float(built.model.layers[0].mlp.up_proj.weight.float().std())
    if abs(std - 0.02) > 0.002:
        raise AssertionError(f"init_params_leafwise: std {std}, want 0.02")
    resident = LlamaForCausalLM(cfg2)
    resident.load_state_dict({k: v.cuda() for k, v in built.state_dict().items()})
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, MODEL["vocab_size"],
                                                             (2, 32))).cuda()
    gc = GenerationConfig(max_new_tokens=8)
    if not torch.equal(generate_streamed(built, ids, gc), generate(resident, ids, gc)):
        raise AssertionError("init_params_leafwise: streamed tokens differ from generate's")
    out["init_params_leafwise"] = {"layers": 2, "pinned_layer": 1, "std": std,
                                   "streamed_equals_generate": True}
    del built, resident

    block = model.model.layers[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(BIG["batch"], BIG["prompt"], MODEL["hidden_size"], generator=g,
                    device="cuda").to(torch.bfloat16)
    positions = torch.arange(BIG["prompt"], device="cuda").expand(BIG["batch"], -1)
    args = (x, positions, model.rope_cos, model.rope_sin)
    ref = block(*args)
    state = {k: v.detach() for k, v in _named_tensors(block).items()}
    checks = {}

    def same(label, got):
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: the layer's output differs from its resident one")
        checks[label] = True

    placed, run = cpu_offload(dict(state), apply_fn=block, execution_device="cuda")
    if not all(t.device.type == "cpu" and t.is_pinned() for t in placed.values()):
        raise AssertionError("cpu_offload: a tensor not in pinned host memory")
    same("cpu_offload + offloaded_apply", run(placed, *args))
    on_disk, run = disk_offload(dict(state), folder / "layer", apply_fn=block,
                                execution_device="cuda")
    same("disk_offload + offloaded_apply", run(on_disk, *args))
    mapped = offload_store_params(offload_state_dict(folder / "state", state))
    if not all(file_span(t) is not None for t in mapped.values()):
        raise AssertionError("offload_store_params: a tensor not over its file")
    same("offload_state_dict + offload_store_params", offloaded_apply(block, "cuda")(mapped, *args))
    store = OffloadStore(folder / "layer")
    with init_empty_weights():
        shell = LlamaBlock(model.config)
    hook = AlignDevicesHook("cuda", weights_map={k: store.load(k) for k in state})
    add_hook_to_module(shell, hook)
    same("AlignDevicesHook over memory maps", shell(*args))
    same("AlignDevicesHook over memory maps, again", shell(*args))
    if not (hook._staging.buffers[0].is_pinned()
            and all(p.device.type == "meta" for p in shell.parameters())):
        raise AssertionError("AlignDevicesHook: no pinned slot, or the copies were kept")
    with init_empty_weights():
        shell = LlamaBlock(model.config)
    attach_align_device_hook(shell, "cuda", offload=False, weights_map=placed)
    same("AlignDevicesHook, offload=False", shell(*args))
    if any(p.device.type != "cuda" for p in shell.parameters()):
        raise AssertionError("AlignDevicesHook(offload=False): weights not kept on the card")
    same("AlignDevicesHook, offload=False, again", shell(*args))
    kept = add_hook_to_module(copy.deepcopy(block), CpuOffloadHook("cuda"))
    if not all(p.device.type == "cpu" and p.is_pinned() for p in kept.parameters()):
        raise AssertionError("CpuOffloadHook: weights not in pinned host memory")
    same("CpuOffloadHook", kept(*args))

    cast, _ = layerwise_casting(copy.deepcopy(block))
    stored = {k: t for k, t in _named_tensors(cast).items() if t.dtype == torch.float8_e4m3fn}
    if len(stored) != 7:
        raise AssertionError(f"layerwise_casting stored {len(stored)} fp8 weights, want 7")
    rounded = {k: v.to(torch.float8_e4m3fn).to(torch.bfloat16) if k in stored else v
               for k, v in state.items()}
    want = torch.func.functional_call(block, rounded, args)
    got = cast(*args)
    if not torch.equal(got, want) or torch.equal(got, ref):
        raise AssertionError("layerwise_casting: not the layer on its fp8-rounded weights")
    if any(t.dtype != torch.float8_e4m3fn for k, t in _named_tensors(cast).items()
           if k in stored):
        raise AssertionError("layerwise_casting: weights not stored again after the call")
    checks["layerwise_casting (fp8)"] = True

    qblock = qref.model.layers[0]
    dense = {f"{name}.weight": dequantize(mod.quantized, torch.bfloat16).t()
             for name, mod in qblock.named_modules()
             if isinstance(mod, QuantizableDense) and mod.quantized is not None}
    others = {k: v for k, v in _named_tensors(qblock).items() if k.endswith("layernorm.weight")}
    want = torch.func.functional_call(block, {**dense, **others}, args)
    if not torch.equal(quantized_apply(qblock)(*args), want):
        raise AssertionError("quantized_apply: not the layer on its dequantized weights")
    if any(mod.quantized is None for mod in qblock.modules() if isinstance(mod, QuantizableDense)):
        raise AssertionError("quantized_apply: the int8 layer was not restored")
    checks["quantized_apply"] = True
    out["layer_bitwise"] = checks
    return out


def big_model_phase(torch, card: str, bf16: dict, quant: dict) -> dict:
    """Big-model inference from a checkpoint (module docstring, 5a'''):
    the bf16 serve's weights written as HF shards; ``load_checkpoint_and_serve``
    into a meta model (the weights bitwise, the tokens of the same weights'
    in-process serve bitwise, #4 / #6 held to plain); ``load_and_quantize_model``
    (codes and scales ``quantize_model_``'s bitwise, its peak device memory
    under the int8 model + the largest bf16 weight with its quantizer's
    three f32 temporaries) served from int8 pages (#5 / #7 / #11, the token
    rule against the in-process int8 serve); both models tiered over the
    card, pinned host and disk and decoded by ``generate_streamed``
    (:func:`streamed_case`; the int8 one through #11 / #12, held to
    plain); ``beam_search`` on both (:func:`beam_case`; #11 / #12 held to
    plain)."""
    import dataclasses
    import shutil
    import tempfile

    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import (
        GenerationConfig, QuantizationConfig, ServingPlugin, compute_module_sizes,
        dispatch_model, infer_auto_placement, load_and_quantize_model, load_checkpoint_and_serve,
        load_hf_llama,
    )
    from accelerate_tpu_torch.big_modeling import _lookup_placement, _named_tensors
    from accelerate_tpu_torch.models.layers import QuantizableDense
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.ops.streaming import file_span
    from accelerate_tpu_torch.utils.quantization import quantized_nbytes

    model, qref = bf16["model"], quant["model"]
    layers = model.config.num_hidden_layers
    trace = capped(bf16["trace"], CHECKED_NEW)
    check_trace = trace[:BIG["check_requests"]]
    folder = Path(tempfile.mkdtemp(prefix="big_model_"))
    out = {"card": card}
    try:
        ckpt = folder / "hf"
        out["checkpoint"] = write_hf_checkpoint(torch, model, ckpt, BIG["shards"])
        log("big_model checkpoint", json.dumps(out["checkpoint"]))

        # the bf16 checkpoint served from a meta model (the first meta build
        # of a process pays torch's one-time import of its meta kernels)
        t0 = time.perf_counter()
        empty = empty_llama(torch)
        meta_s = time.perf_counter() - t0
        base = settled_allocated(torch)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        engine = load_checkpoint_and_serve(
            empty, ckpt, serving_plugin=ServingPlugin(**PLUGIN),
            generation_config=GenerationConfig(max_new_tokens=MAX_NEW), stats=stats)
        sync(torch)
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        loaded = engine.model
        t0 = time.perf_counter()
        held_equal(torch, loaded.state_dict(), model.state_dict(), "loaded bf16 weights")
        sync(torch)
        verify_s = time.perf_counter() - t0
        engine.warmup()
        engine, report, launches, _ = serve_once(torch, loaded, trace, engine=engine)
        m = engine.metrics
        expect_launches(launches, {"paged_decode_attention": m["decode_steps"] * layers,
                                   "paged_multitoken_attention": m["prefill_steps"] * layers})
        PATH_LAUNCHES["big_model_serve"] = launches
        ref_engine, ref_report, _, _ = serve_once(torch, model, trace)
        if dict(engine.results) != dict(ref_engine.results):
            raise AssertionError("loaded serve: tokens differ from the in-process serve's")
        del engine, ref_engine
        in_path = in_path_check(torch, loaded, llama_mod, fa, qmm, check_trace)
        out["serve"] = {
            "meta_build_ms": 1e3 * meta_s, "load_ms": 1e3 * load_s,
            "read_ms": 1e3 * stats["read_s"], "h2d_ms": 1e3 * stats["h2d_s"],
            "plan_and_engine_ms": 1e3 * (load_s - stats["read_s"] - stats["h2d_s"]),
            "verify_ms": 1e3 * verify_s,
            "bytes": stats["bytes"], "load_gb_s": stats["bytes"] / load_s / 1e9,
            "read_gb_s": stats["bytes"] / stats["read_s"] / 1e9,
            "h2d_gb_s": stats["bytes"] / stats["h2d_s"] / 1e9, "peak_bytes": peak,
            "requests": len(trace), "tokens_bitwise_in_process": True,
            "tokens_per_sec": report["tokens_per_sec"],
            "in_process_tokens_per_sec": ref_report["tokens_per_sec"],
            "launches": launches, "in_path": in_path}
        log("big_model serve", json.dumps(out["serve"]))

        # int8 on load, served from int8 pages
        base = settled_allocated(torch)
        torch.cuda.reset_peak_memory_stats()
        qstats = {}
        empty = empty_llama(torch)
        t0 = time.perf_counter()
        qloaded = load_and_quantize_model(empty, ckpt, QuantizationConfig(load_in_8bit=True),
                                          stats=qstats)
        sync(torch)
        qload_s = time.perf_counter() - t0
        qpeak = torch.cuda.max_memory_allocated() - base
        held_equal(torch, qloaded.state_dict(), qref.state_dict(), "int8 codes and scales")
        int8_bytes = quantized_nbytes(qloaded)
        largest = max(mod.in_features * mod.out_features * 2 for mod in qloaded.modules()
                      if isinstance(mod, QuantizableDense) and mod.quantized is not None)
        qbound = int8_bytes + 7 * largest      # the bf16 weight + three f32 temporaries
        if qpeak > qbound:
            raise AssertionError(f"int8 load: peak {qpeak} B above {qbound} B")
        qengine, qreport, qlaunches, _ = serve_once(torch, qloaded, trace, QUANT_KV)
        m = qengine.metrics
        expect_launches(qlaunches, {
            "paged_decode_attention_quant": m["decode_steps"] * layers,
            "paged_multitoken_attention_quant": m["prefill_steps"] * layers,
            "quantized_matmul_tiled": 7 * layers * (m["decode_steps"] + m["prefill_steps"])})
        PATH_LAUNCHES["big_model_serve_int8"] = qlaunches
        qref_engine, _, _, _ = serve_once(torch, qref, trace, QUANT_KV)
        rule = token_rule(torch, qref, llama_mod, fa, qmm, trace, qref_engine.results,
                          qengine.results, kv_dtype=QUANT_KV, label="big_model int8")
        del qengine, qref_engine
        q_in_path = in_path_check(torch, qloaded, llama_mod, fa, qmm, check_trace,
                                  kv_dtype=QUANT_KV)
        out["serve_int8"] = {
            "load_ms": 1e3 * qload_s, "read_ms": 1e3 * qstats["read_s"],
            "h2d_ms": 1e3 * qstats["h2d_s"], "quantize_ms": 1e3 * qstats["quantize_s"],
            "peak_bytes": qpeak, "peak_bound_bytes": qbound, "int8_model_bytes": int8_bytes,
            "largest_bf16_weight_bytes": largest, "codes_bitwise_quantize_model_": True,
            "tokens_per_sec": qreport["tokens_per_sec"], "token_rule": rule,
            "launches": qlaunches, "in_path": q_in_path}
        log("big_model serve_int8", json.dumps(out["serve_int8"]))

        # tiered: card, pinned host, disk; the layer-streamed decode
        rng = np.random.default_rng(7)
        ids = torch.from_numpy(rng.integers(1, MODEL["vocab_size"], (BIG["batch"],
                                                                     BIG["prompt"]))).cuda()
        sizes = compute_module_sizes(model)
        budget = {0: int(BIG["card_share"] * sizes[""]),
                  "cpu": BIG["cpu_layers"] * sizes["model.layers.0"]}
        placement = infer_auto_placement(empty_llama(torch), max_memory=budget)
        tiers = {placement.get(f"model.layers.{i}") for i in range(layers)}
        if not {"cpu", "disk"} <= tiers:
            raise AssertionError(f"placement puts no layer on cpu and disk: {placement}")
        # the user's call: load_hf_llama plans the same tiers from max_memory
        tiered, store = load_hf_llama(empty_llama(torch), ckpt, max_memory=budget,
                                      offload_folder=str(folder / "offload"))
        for name, t in _named_tensors(tiered).items():
            tier = _lookup_placement(name, placement)
            where = "disk" if file_span(t) is not None else \
                "cpu" if t.device.type == "cpu" and t.is_pinned() else \
                0 if t.device.type == "cuda" else t.device.type
            if where != tier:
                raise AssertionError(f"load_hf_llama put {name} on {where}, the plan {tier}")
        out["streamed"] = streamed_case(torch, "bf16", tiered, model, ids, placement, store,
                                        budget)
        log("big_model streamed bf16", json.dumps(out["streamed"]))
        del tiered, store
        qsizes = compute_module_sizes(qloaded)
        qbudget = {0: int(BIG["card_share"] * qsizes[""]),
                   "cpu": BIG["cpu_layers"] * qsizes["model.layers.0"]}
        qplacement = infer_auto_placement(qloaded, max_memory=qbudget)
        qloaded, qstore = dispatch_model(qloaded, qplacement,
                                         offload_folder=str(folder / "qoffload"))
        out["streamed_int8"] = streamed_case(torch, "int8", qloaded, qref, ids, qplacement,
                                             qstore, qbudget)
        PATH_LAUNCHES["streamed"] = out["streamed_int8"]["launches"]
        expect_launches(PATH_LAUNCHES["streamed"], {
            "quantized_matmul_tiled": 7 * layers, "quantized_matmul_wholef":
            7 * layers * (BIG["new"] - 1)})
        from accelerate_tpu_torch import generate_streamed

        readings = {}
        with checked_kernels(torch, llama_mod, fa, qmm, readings):
            generate_streamed(qloaded, ids, GenerationConfig(max_new_tokens=BIG["new"]))
        out["streamed_int8"]["in_path"] = worst_readings(
            readings, ["quantized_matmul_tiled", "quantized_matmul_wholef"])
        log("big_model streamed int8", json.dumps(out["streamed_int8"]))
        del qloaded, qstore

        # beam search on the resident bf16 and int8 models
        b_ids = ids[:BIG["beam_batch"]]
        out["beam"] = beam_case(torch, "bf16", model, b_ids)
        out["beam_int8"] = beam_case(torch, "int8", qref, b_ids)
        PATH_LAUNCHES["beam"] = out["beam_int8"]["launches"]
        expect_launches(PATH_LAUNCHES["beam"], {
            "quantized_matmul_tiled": 7 * layers,
            "quantized_matmul_wholef": 7 * layers * (BIG["beam_new"] - 1)})
        readings = {}
        from accelerate_tpu_torch import beam_search

        with checked_kernels(torch, llama_mod, fa, qmm, readings):
            beam_search(qref, b_ids, GenerationConfig(max_new_tokens=BIG["beam_new"]),
                        num_beams=BIG["beams"])
        out["beam_int8"]["in_path"] = worst_readings(
            readings, ["quantized_matmul_tiled", "quantized_matmul_wholef"])
        log("big_model beam", json.dumps({"bf16": out["beam"], "int8": out["beam_int8"]}))

        t0 = time.perf_counter()
        out["entry_points"] = entry_points_case(torch, model, qref, folder)
        out["entry_points"]["seconds"] = time.perf_counter() - t0
        log("big_model entry points", json.dumps(out["entry_points"]))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
        torch.cuda.empty_cache()
    s, q, st, sq = out["serve"], out["serve_int8"], out["streamed"], out["streamed_int8"]
    log(f"big_model on {card}: checkpoint {out['checkpoint']['bytes'] / 1e9:.3f} GB written at "
        f"{out['checkpoint']['write_gb_s']:.2f} GB/s; meta build {s['meta_build_ms']:.0f} ms, "
        f"bf16 load {s['load_ms']:.0f} ms (read {s['read_ms']:.0f}, H2D {s['h2d_ms']:.0f}, "
        f"plan + engine {s['plan_and_engine_ms']:.0f}; verify {s['verify_ms']:.0f}), "
        f"{s['load_gb_s']:.2f} GB/s; int8 load {q['load_ms']:.0f} ms, peak "
        f"{q['peak_bytes'] / 2**20:.1f} MiB (bound {q['peak_bound_bytes'] / 2**20:.1f}); "
        f"streamed bf16 {st['tokens_per_s']['prefetch']:.1f} / serial "
        f"{st['tokens_per_s']['serial']:.1f} / resident {st['tokens_per_s']['resident_generate']:.1f}"
        f" tokens/s, overlap {st['overlap_frac']:.3f} (predicted {st['predicted_overlap']:.3f}),"
        f" H2D {st['achieved_h2d_gb_s']:.2f} GB/s (bare {st['bare_pinned_h2d_gb_s']:.2f}), "
        f"staging the disk tier {st['staging_gb_s']['copy_through_map']:.2f} GB/s through the "
        f"maps, {st['staging_gb_s']['pread']:.2f} by pread; "
        f"int8 {sq['tokens_per_s']['prefetch']:.1f} tokens/s; beams "
        f"{out['beam']['tokens_per_s']:.1f} / {out['beam_int8']['tokens_per_s']:.1f} tokens/s")
    return out


def quant_engine_phase(torch, card: str, bf16: dict, device: str = "cuda") -> dict:
    """The 600m model with int8 weights serving the same trace from int8
    pages: launches, pool bytes, a checked second serve, the teacher-forced
    check; its metrics beside the bf16 serve's."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import (
        LlamaConfig, LlamaForCausalLM, QuantizationConfig, quantize_model_,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.serving.paged_cache import kv_page_bytes
    from accelerate_tpu_torch.utils.quantization import quantized_nbytes

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = quantize_model_(LlamaForCausalLM(cfg, device=device, seed=0),
                            QuantizationConfig(load_in_8bit=True))
    trace = bf16["trace"]
    engine, report, launches, _ = serve_once(torch, model, trace, QUANT_KV)
    m = engine.metrics
    layers = cfg.num_hidden_layers
    expect_launches(launches, {
        "paged_decode_attention_quant": m["decode_steps"] * layers,
        "paged_multitoken_attention_quant": m["prefill_steps"] * layers,
        "quantized_matmul_tiled": 7 * layers * (m["decode_steps"] + m["prefill_steps"])})
    pool_bytes = sum(t.numel() * t.element_size() for layer in engine.cache["layers"]
                     for t in layer.values())
    per_page = pool_bytes / PLUGIN["num_pages"]
    if per_page != kv_page_bytes(cfg, PLUGIN["page_size"], kv_dtype=QUANT_KV):
        raise AssertionError(f"pool bytes per page {per_page} != kv_page_bytes "
                             f"{kv_page_bytes(cfg, PLUGIN['page_size'], kv_dtype=QUANT_KV)}")
    # greedy tokens matching the bf16 serve, position by position (not
    # gated: the model is random)
    same = total = 0
    for r in trace:
        a, b = engine.results[r.uid], bf16["results"][r.uid]
        same += sum(x == y for x, y in zip(a, b))
        total += len(b)
    bf = bf16["report"]
    rep = {"card": card, "kv_dtype": QUANT_KV, "weights": "int8 (W8A16)", **report,
           "launches": launches, "weight_bytes": quantized_nbytes(model),
           "bf16_weight_bytes": bf16["weight_bytes"], "pool_bytes": pool_bytes,
           "bf16_pool_bytes": kv_page_bytes(cfg, PLUGIN["page_size"]) * PLUGIN["num_pages"],
           "pool_bytes_per_page": per_page, "greedy_tokens_matching_bf16": same / total,
           "bf16": {k: bf[k] for k in ("tokens_per_sec", "ttft_p50_ms", "p50_token_latency_ms",
                                       "p99_token_latency_ms")}}
    log("quant_engine", json.dumps(rep))
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace, kv_dtype=QUANT_KV)
    log("quant_in_path", json.dumps(in_path))
    checks = [teacher_forced_check(torch, model, llama_mod, fa, qmm, trace[i],
                                   engine.results[trace[i].uid], kv_dtype=QUANT_KV)
              for i in (0, 1)]
    log("quant_teacher_forced", json.dumps(checks))
    log(f"quantized serving on {card}: {report['tokens_per_sec']:.1f} tokens/s "
        f"(bf16 {bf['tokens_per_sec']:.1f}), TTFT p50 {report['ttft_p50_ms']:.2f} ms "
        f"({bf['ttft_p50_ms']:.2f}), token latency p50 {report['p50_token_latency_ms']:.3f} / "
        f"p99 {report['p99_token_latency_ms']:.3f} ms ({bf['p50_token_latency_ms']:.3f} / "
        f"{bf['p99_token_latency_ms']:.3f}); weights {rep['weight_bytes'] / 2**20:.1f} MiB "
        f"({rep['bf16_weight_bytes'] / 2**20:.1f}); pool {pool_bytes / 2**20:.2f} MiB "
        f"({rep['bf16_pool_bytes'] / 2**20:.2f}); greedy tokens matching bf16 "
        f"{100 * rep['greedy_tokens_matching_bf16']:.1f} %")
    return {"model": model, "launches": launches, "in_path": in_path, "report": rep,
            "results": dict(engine.results)}


def pages_32_phase(torch, model, card: str, trace) -> dict:
    """The int8-weight model serving the trace's first requests from int8
    pages of 32 tokens under ``decode_kernel="auto"``: every request
    finishes through #5 and #7 (and #11), once per layer of every step;
    then again with every launch held against its plain version."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    trace = trace[:PAGES_32_REQUESTS]
    engine, report, launches, _ = serve_once(torch, model, trace, QUANT_KV, plugin=PAGES_32)
    m = engine.metrics
    layers = MODEL["num_hidden_layers"]
    expect_launches(launches, {
        "paged_decode_attention_quant": m["decode_steps"] * layers,
        "paged_multitoken_attention_quant": m["prefill_steps"] * layers,
        "quantized_matmul_tiled": 7 * layers * (m["decode_steps"] + m["prefill_steps"])})
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace, kv_dtype=QUANT_KV,
                            plugin=PAGES_32)
    rep = {"card": card, "kv_dtype": QUANT_KV, "page_size": PAGES_32["page_size"],
           "decode_kernel": PAGES_32["decode_kernel"], "requests": len(trace), **report,
           "launches": launches, "in_path": in_path}
    log("pages_32", json.dumps(rep))
    return rep


@contextlib.contextmanager
def recorded_engines(serving_mod):
    """The :class:`ServingEngine` instances built while the block runs
    (``generate_paged`` builds its own), in a list."""
    built, base = [], serving_mod.ServingEngine

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    serving_mod.ServingEngine = Recorded
    try:
        yield built
    finally:
        serving_mod.ServingEngine = base


@contextlib.contextmanager
def wholef_kernels_seen(torch):
    """Count, under ``torch.profiler``, the device kernels the block runs
    that are #12's (``qmm_wholef_kernel``) and the second pass its earlier
    design launched (``reduce_splits_kernel``: none now)."""
    from torch.profiler import ProfilerActivity, profile

    seen = {"qmm_wholef": 0, "other_qmm": 0}
    if not torch.cuda.is_available():      # a CPU rehearsal: no kernel to see
        yield seen
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield seen
    sync(torch)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise AssertionError("torch.profiler saw no device kernel: cannot count #12's launches")
    for e in device:
        if "qmm_wholef_kernel" in e.name:
            seen["qmm_wholef"] += 1
        elif "reduce_splits" in e.name:
            seen["other_qmm"] += 1


def generate_paged_phase(torch, model, card: str, kv_dtype: str = GEN_PAGED["kv_dtype"]) -> dict:
    """``generate_paged`` at batch 4, held to the steps its engine
    counted: with int8 weights and fp8 pages, #12 on every decode step, #11
    on every prefill chunk, #5 / #7 over the pages; with bf16 weights and
    pages (``kv_dtype="bf16"``), #4 and #6.  Then the same call for its
    first ``GEN_CHECKED_NEW`` tokens with every launch held against its
    plain version, under ``torch.profiler``: as many #12 device kernels as
    #12 calls, the tokens those of the first call."""
    import accelerate_tpu_torch.models.llama as llama_mod
    import accelerate_tpu_torch.serving as serving_mod
    from accelerate_tpu_torch import GenerationConfig, ServingPlugin, generate_paged
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    b, new = GEN_PAGED["batch"], GEN_PAGED["max_new"]
    rng = np.random.default_rng(1)
    lens = rng.integers(GEN_PAGED["prompt_len_range"][0], GEN_PAGED["prompt_len_range"][1] + 1, b)
    t_prompt = int(lens.max())
    ids = rng.integers(1, MODEL["vocab_size"], (b, t_prompt)).astype(np.int32)
    # generate_paged's own offline provisioning, with fp8 pages
    pages = -(-(t_prompt + new) // 16)
    plugin = dict(num_slots=b, page_size=16, pages_per_slot=pages, num_pages=b * pages,
                  prefill_chunk=max(16, t_prompt), kv_dtype=kv_dtype)
    gc = GenerationConfig(max_new_tokens=new)
    reset_counts()
    t0 = time.perf_counter()
    with recorded_engines(serving_mod) as engines:
        out = generate_paged(model, ids, gc, prompt_lengths=lens,
                             serving_plugin=ServingPlugin(**plugin))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if len(engines) != 1:
        raise AssertionError(f"generate_paged built {len(engines)} engines")
    m = engines[0].metrics
    decode_steps, prefill_steps = m["decode_steps"], m["prefill_steps"]
    if prefill_steps != b:      # one chunk per prompt
        raise AssertionError(f"{prefill_steps} prefill steps for {b} prompts")
    if decode_steps < new - 1:
        raise AssertionError(f"{decode_steps} decode steps for {new} new tokens")
    layers = MODEL["num_hidden_layers"]
    quant = kv_dtype != "bf16"
    expect_launches(launches, {
        "paged_decode_attention_quant": decode_steps * layers,
        "paged_multitoken_attention_quant": prefill_steps * layers,
        "quantized_matmul_tiled": 7 * layers * prefill_steps,
        "quantized_matmul_wholef": 7 * layers * decode_steps} if quant else {
        "paged_decode_attention": decode_steps * layers,
        "paged_multitoken_attention": prefill_steps * layers})
    if tuple(out.shape) != (b, new) or not bool(((out >= 0) & (out < MODEL["vocab_size"])).all()):
        raise AssertionError(f"generate_paged returned {tuple(out.shape)} / out-of-vocab ids")
    readings = {}
    calls = qmm._WRAPPERS["quantized_matmul_wholef"].launches
    with wholef_kernels_seen(torch) as seen, checked_kernels(torch, llama_mod, fa, qmm, readings):
        again = generate_paged(model, ids, GenerationConfig(max_new_tokens=GEN_CHECKED_NEW),
                               prompt_lengths=lens, serving_plugin=ServingPlugin(**plugin))
    calls = qmm._WRAPPERS["quantized_matmul_wholef"].launches - calls
    if torch.cuda.is_available() and (seen["qmm_wholef"] != calls or seen["other_qmm"]):
        raise AssertionError(f"#12: {calls} wrapper calls ran {seen['qmm_wholef']} "
                             f"qmm_wholef kernels and {seen['other_qmm']} other W8A16 kernels "
                             "(one device launch a call)")
    in_path = worst_readings(readings, ["paged_decode_attention", "paged_multitoken_attention"]
                             + (["quantized_matmul_tiled", "quantized_matmul_wholef"] if quant
                                else []))
    rep = {"card": card, "batch": b, "prompt_lens": [int(x) for x in lens], "max_new": new,
           "kv_dtype": plugin["kv_dtype"], "wall_s": wall, "tokens_per_s": b * new / wall,
           "decode_steps": decode_steps, "prefill_steps": prefill_steps, "launches": launches,
           "checked_rerun_new": GEN_CHECKED_NEW,
           "checked_rerun_tokens_equal": bool(torch.equal(out[:, :GEN_CHECKED_NEW], again)),
           "in_path": in_path,
           "wholef_device_kernels_per_call": seen["qmm_wholef"] / calls if calls else None}
    log("generate_paged", json.dumps(rep))
    return {"launches": launches, "in_path": in_path}


# -- multi-tenant LoRA: kernel #10, the LoRA serve, the fused op #8 / #9 ------


def lora_bound(ids, d_in, rank, d_out, y: bool = False):
    """Bytes and flops of #10 for this data: ids read, the whole bf16
    output written (and with ``y``, the fused entry point's, the whole base
    output read), and for the nonzero ids only (an id-0 row's delta is
    zeros, read from nothing) their rows of x and the factors of each
    distinct id read once; 2 flops per multiply-add of those rows."""
    nonzero = [int(i) for i in ids.tolist() if int(i) != 0]
    nbytes = (len(ids) * 4 + len(ids) * d_out * 2 * (2 if y else 1) + len(nonzero) * d_in * 2
              + len(set(nonzero)) * (d_in * rank + rank * d_out) * 2)
    return nbytes, 2 * len(nonzero) * rank * (d_in + d_out)


# filled by main(): ptxas's registers and spilled bytes of each #10 instance
LORA_PTXAS: dict = {}


def lora_case(torch, lora_mod, name, x, y, a, b, ids) -> tuple[dict, dict]:
    """#10 on one set of operands: ``bgmv_apply`` twice (bitwise), bitwise
    the select over the delta-only entry point's output on the same
    operands, id-0 rows ``y`` bitwise; the fused output held to
    ``lora_plain`` and the delta to ``bgmv_plain``.  Returns both
    readings."""
    out = lora_mod.bgmv_apply(x, y, a, b, ids)
    again = lora_mod.bgmv_apply(x, y, a, b, ids)
    delta = lora_mod.bgmv(x, a, b, ids)
    sync(torch)
    bits = lambda t: t.view(torch.int16)
    if not torch.equal(bits(out), bits(again)):
        raise AssertionError(f"{name}: two runs on the same operands differ")
    if not torch.equal(bits(out), bits(torch.where((ids > 0)[:, None], y + delta, y))):
        raise AssertionError(f"{name}: not the select over the kernel's own delta")
    if not torch.equal(bits(out[ids == 0]), bits(y[ids == 0])):
        raise AssertionError(f"{name}: an id-0 row is not y bitwise")
    ref, slack = lora_plain(torch, lora_mod, x, y, a, b, ids)
    held = held_to_plain(torch, name, out[:, None], ref[:, None], slack=slack[:, None])
    ref_delta = lora_mod.bgmv_plain(x.float(), a, b, ids)
    held_delta = held_to_plain(torch, f"{name} (delta)", delta[:, None], ref_delta[:, None],
                               slack=half_ulp_bf16(torch, ref_delta)[:, None])
    return held, held_delta


def lora_kernel_phases(torch, device: str = "cuda") -> dict:
    """#10 with the select folded in (``bgmv_apply``) and its delta alone
    (``bgmv``) at the 600m q_proj and v_proj shapes (16 slots, rank 16, ids
    mixing 0 and 1..4; ``lora_case``), again with B 16 times larger (deltas
    well above 8, where one bf16 rounding moves an output by more than
    KERNEL_TOL); timed as 20 launches in a CUDA graph beside its plain
    version, its bound (y read too), the delta alone, the route it
    replaces (the delta, then the id test, the add and the select: four
    launches; with ``--before``, DIR's) and the gathered ``torch.bmm``
    pair.  Enough copies of the operands rotate between launches that each
    finds its factors out of the L2, as a layer of the real decode step
    does."""
    from accelerate_tpu_torch.ops import lora as lora_mod

    gen = torch.Generator(device=device).manual_seed(10)
    rank, pool = LORA["rank"], LORA["pool_slots"] + 1
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=device)
    slots = len(LORA_IDS)
    cases = []
    for label, (d_in, d_out) in LORA_SHAPES.items():
        stack_bytes = pool * rank * (d_in + d_out) * 2
        copies = max(2, -(-2 * L2_BYTES // stack_bytes))
        stacks = []
        for _ in range(copies):
            a = (torch.randn(pool, d_in, rank, generator=gen, device=device) / d_in ** 0.5)
            b = (torch.randn(pool, rank, d_out, generator=gen, device=device) / rank ** 0.5)
            a[0], b[0] = 0, 0
            x = torch.randn(slots, d_in, generator=gen, device=device).bfloat16()
            y = torch.randn(slots, d_out, generator=gen, device=device).bfloat16()
            stacks.append((x, y, a.bfloat16(), b.bfloat16()))
        x, y, a, b = stacks[0]
        y[:, 0] = -0.0          # id-0 rows keep it, live rows add to it
        held, held_delta = lora_case(torch, lora_mod, f"bgmv_apply {label}", x, y, a, b, ids)
        big, big_delta = lora_case(torch, lora_mod, f"bgmv_apply {label} x16", x, y, a, b * 16,
                                   ids)
        rot = lambda fn: (lambda i: fn(*stacks[i % copies], ids))
        ms = time_ms(torch, rot(lora_mod.bgmv_apply), graph=True)
        plain_ms = time_ms(torch, rot(lora_mod.bgmv_apply_plain), iters=5)
        delta_ms = time_ms(torch, lambda i: lora_mod.bgmv(stacks[i % copies][0],
                                                          *stacks[i % copies][2:], ids),
                           graph=True)

        def four_launches(x, y, a, b, ids):
            return torch.where((ids > 0)[:, None], y + lora_mod.bgmv(x, a, b, ids), y)

        four_launch_ms = time_ms(torch, rot(four_launches), graph=True)
        before = {}
        if "bgmv_apply" in BEFORE:
            early = BEFORE["bgmv_apply"](x, y, a, b, ids)
            sync(torch)
            ref, slack = lora_plain(torch, lora_mod, x, y, a, b, ids)
            before["before_err_over_limit"] = held_to_plain(
                torch, f"bgmv_apply {label} (earlier route)", early[:, None], ref[:, None],
                slack=slack[:, None])["err_over_limit"]
            before["before_ms"] = time_ms(torch, rot(BEFORE["bgmv_apply"]), graph=True)
        idx = ids.long()
        library_ms = time_ms(torch, lambda i: torch.bmm(
            torch.bmm(stacks[i % copies][0][:, None], stacks[i % copies][2][idx]),
            stacks[i % copies][3][idx]), graph=True)
        nbytes, flops = lora_bound(ids, d_in, rank, d_out, y=True)
        bound_ms, bound_by = bound(nbytes, flops)
        rep = {**held, "delta": {k: held_delta[k] for k in ("max_abs_err", "err_over_limit")},
               "large_delta": {"ref_max": big_delta["tensor_ref_max"],
                               "max_abs_err": big["max_abs_err"],
                               "err_over_limit": big["err_over_limit"],
                               "delta_err_over_limit": big_delta["err_over_limit"]},
               "ms": ms, "plain_ms": plain_ms, "delta_ms": delta_ms,
               "four_launch_ms": four_launch_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, **before,
               "shape": {"dense": label, "slots": slots, "d_in": d_in, "d_out": d_out,
                         "rank": rank, "pool_slots": pool, "ids": LORA_IDS,
                         "stack_copies": copies}}
        log("kernel bgmv_apply", json.dumps(rep))
        cases.append(rep)
    main = _with_cases(cases, cases[0])
    for key in ("delta_ms", "four_launch_ms", "before_ms"):
        if key in cases[0]:
            main[key] = cases[0][key]
    main["ptxas"] = LORA_PTXAS
    main["library_call"] = "gathered torch.bmm pair (a_stack[ids], b_stack[ids], two bmm)"
    return {"bgmv_apply": main}


def lora_store(torch, model):
    """The pool of ``LORA`` over ``model`` with the 8 tenants published, each
    from its own seeded generator (seed 1000 + tenant, init_b="normal")."""
    from accelerate_tpu_torch import AdapterStore, LoraPlugin

    store = AdapterStore(model, LoraPlugin(**LORA))
    for t in range(1, LORA_TENANTS + 1):
        store.publish_random(t, torch.Generator().manual_seed(1000 + t), init_b="normal")
    return store


def base_rows_check(torch, model, trace, store, prefill=48, decode=16) -> dict:
    """A live base-model row (adapter id 0) beside an adapter row, teacher
    forced through the paged path (one prefill chunk of ``prefill`` prompt
    tokens, then ``decode`` single-token steps, where #10 runs): the id-0
    row's logits must be bitwise those of the same batch run without
    adapters, and the adapter row's must differ from its base logits."""
    from accelerate_tpu_torch.models.llama import init_paged_cache

    dev, page = model.device, PLUGIN["page_size"]
    first = next(r for r in trace if r.adapter_id)
    other = next(r for r in trace if r.uid != first.uid)
    n = prefill + decode
    tokens = torch.tensor([list(other.prompt[:n]), list(first.prompt[:n])], device=dev)
    pos = torch.arange(n, device=dev)[None].expand(2, n)
    n_pages = -(-n // page)
    slot, _ = store.pin(first.adapter_id)
    lora_kw = dict(adapter_ids=torch.tensor([0, slot], device=dev), lora=store.pool)

    def run(**kw):
        cache = init_paged_cache(model.config, 2 * n_pages, page, 2, n_pages, device=dev)
        bt = torch.arange(2 * n_pages, dtype=torch.int32, device=dev).reshape(2, n_pages)
        layers = [{**l, "block_tables": bt} for l in cache["layers"]]
        out = []
        with torch.inference_mode():
            for a, b in [(0, prefill)] + [(t, t + 1) for t in range(prefill, n)]:
                lg, layers = model(tokens[:, a:b], positions=pos[:, a:b], cache=layers,
                                   cache_write_mask=torch.ones(2, b - a, dtype=torch.bool,
                                                               device=dev), **kw)
                out.append(lg)
        return torch.cat(out, dim=1)

    with_lora, without = run(**lora_kw), run()
    store.unpin(first.adapter_id)
    rep = {"uids": [other.uid, first.uid], "adapter_ids": [0, first.adapter_id],
           "positions": n, "base_row_bitwise": bool(torch.equal(with_lora[0], without[0])),
           "adapter_row_max_abs_dlogit": (with_lora[1] - without[1]).abs().max().item()}
    if not (rep["base_row_bitwise"] and rep["adapter_row_max_abs_dlogit"] > 0):
        raise AssertionError(f"base-model row beside an adapter row: {rep}")
    return rep


def lora_engine_phase(torch, card: str, bf16: dict) -> dict:
    """The 600m model serving the 8-tenant trace from a pool of 4: launches,
    swaps and swap bytes, a checked second serve, the teacher-forced check;
    its metrics beside the bf16 serve's."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import synthesize_trace
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.serving import adapter_pool_accounting

    model = bf16["model"]
    layers = model.config.num_hidden_layers
    trace = synthesize_trace(0, N_REQUESTS, **TRACE, adapters=LORA_TENANTS)
    store = lora_store(torch, model)
    engine, report, launches, _ = serve_once(torch, model, trace, adapters=store)
    m = engine.metrics
    expect_launches(launches, {"paged_decode_attention": m["decode_steps"] * layers,
                               "paged_multitoken_attention": m["prefill_steps"] * layers,
                               "bgmv_apply": 2 * layers * m["decode_steps"]})
    if not (report["adapter_swaps"] > 0
            and report["adapter_swap_bytes"] == report["adapter_swaps"] * LORA_ADAPTER_BYTES):
        raise AssertionError(f"{report['adapter_swaps']} swaps moved "
                             f"{report['adapter_swap_bytes']} bytes, expected "
                             f"{LORA_ADAPTER_BYTES} each")
    bf = bf16["report"]
    rep = {"card": card, "lora": {**LORA, "targets": list(LORA["targets"])},
           "tenants": LORA_TENANTS, **report, "launches": launches,
           "pool_bytes": sum(t.numel() * t.element_size() for fac in store.pool.values()
                             for t in fac.values()),
           "pool_accounting": adapter_pool_accounting(store.spec, rank=LORA["rank"],
                                                      pool_slots=LORA["pool_slots"]),
           "bf16": {k: bf[k] for k in ("tokens_per_sec", "ttft_p50_ms", "p50_token_latency_ms",
                                       "p99_token_latency_ms")}}
    log("lora_engine", json.dumps(rep))
    in_path = in_path_check(torch, model, llama_mod, fa, qmm, trace,
                            adapters=lora_store(torch, model))
    log("lora_in_path", json.dumps(in_path))
    first = next(r for r in trace if r.adapter_id)
    checks = [teacher_forced_check(torch, model, llama_mod, fa, qmm, first,
                                   engine.results[first.uid], adapters=store)]
    log("lora_teacher_forced", json.dumps(checks))
    base_rows = base_rows_check(torch, model, trace, store)
    log("lora_base_rows", json.dumps(base_rows))
    log(f"LoRA serving on {card}: {report['tokens_per_sec']:.1f} tokens/s "
        f"(bf16 {bf['tokens_per_sec']:.1f}), TTFT p50 {report['ttft_p50_ms']:.2f} ms "
        f"({bf['ttft_p50_ms']:.2f}), token latency p50 {report['p50_token_latency_ms']:.3f} / "
        f"p99 {report['p99_token_latency_ms']:.3f} ms ({bf['p50_token_latency_ms']:.3f} / "
        f"{bf['p99_token_latency_ms']:.3f}); pool hit rate {report['adapter_pool_hit_rate']} "
        f"(predicted {report['adapter_pool_hit_rate_predicted']}), "
        f"{report['adapter_swaps']} swaps, {report['adapter_swap_bytes']} bytes")
    return {"launches": launches, "in_path": in_path, "report": rep, "trace": trace,
            "store": store}


def lora_decode_operands(torch, model, store, trace, kv_dtype: str) -> dict:
    """A LoRA engine's operands after ``LORA_TICKS`` decode ticks, for the
    fused op: layer 0's pages (and scales), the block tables, each slot's
    last written position (-1 for an empty slot: no page is read), the
    tokens at those positions through layer 0's input norm (x), their
    roped base queries, the slots' adapter pool slots, layer 0's q_proj
    stacks and the model's rope tables."""
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin
    from accelerate_tpu_torch.models.llama import apply_rope

    engine = ServingEngine(model, ServingPlugin(**PLUGIN, kv_dtype=kv_dtype),
                           GenerationConfig(max_new_tokens=MAX_NEW), device=model.device,
                           adapters=store)
    engine.warmup()
    pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
    while engine.metrics["decode_steps"] < LORA_TICKS:
        while pending and pending[0].arrival_step <= engine.steps:
            engine.add_request(pending.pop(0))
        engine.step()
    dev, cfg = model.device, model.config
    slots = PLUGIN["num_slots"]
    seq = engine.cache["seq_lens"].cpu()
    pos = torch.full((slots,), -1, dtype=torch.int32)
    tokens = torch.zeros(slots, dtype=torch.long)
    ids = torch.zeros(slots, dtype=torch.int32)
    for s, st in engine.sched.slots.items():
        n = int(seq[s])
        if n:
            pos[s], tokens[s] = n - 1, (list(st.request.prompt) + st.tokens)[n - 1]
            ids[s] = st.adapter_slot
    pos, ids = pos.to(dev), ids.to(dev)
    block = model.model.layers[0]
    h, d = cfg.num_attention_heads, cfg.head_dim
    x = block.input_layernorm(model.model.embed_tokens(tokens.to(dev)))
    q = block.self_attn.q_proj(x[:, None]).reshape(slots, 1, h, d)
    q_base = apply_rope(q, model.rope_cos, model.rope_sin, pos[:, None])[:, 0].contiguous()
    layer = engine.cache["layers"][0]
    stacks = store.pool["model.layers.0.self_attn.q_proj"]
    return {"x": x.contiguous(), "q_base": q_base, "a": stacks["a"], "b": stacks["b"],
            "ids": ids, "cos": model.rope_cos, "sin": model.rope_sin,
            "pages": [layer["k_pages"], layer["v_pages"]],
            "scales": ([layer["k_scales"], layer["v_scales"]] if "k_scales" in layer else []),
            "bt": engine.cache["block_tables"].clone(), "pos": pos,
            "operands": f"LoRA engine after {engine.metrics['decode_steps']} decode ticks"}


def synthetic_fused_operands(torch, kv_dtype: str, device: str = "cuda") -> dict:
    """#4's 16-slot decode case (``paged_case`` at ``DEC_POS``) with random
    x, q_base and q_proj stacks, ids ``LORA_IDS``: #8 / #9 at the shape #4 /
    #5 are timed at, for the prediction's comparison."""
    from accelerate_tpu_torch.models.llama import rope_frequencies

    case = paged_case(torch, slots=16, width=1, pos0=DEC_POS, seed=8,
                      kv_dtype=None if kv_dtype == "bf16" else kv_dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(9)
    d_in, h, d, rank = MODEL["hidden_size"], case["h"], case["d"], LORA["rank"]
    pool = LORA["pool_slots"] + 1
    a = torch.randn(pool, d_in, rank, generator=gen, device=device) / d_in ** 0.5
    b = torch.randn(pool, rank, h * d, generator=gen, device=device) / rank ** 0.5
    a[0], b[0] = 0, 0
    cos, sin = (torch.from_numpy(t).to(device) for t in
                rope_frequencies(d, MODEL["max_position_embeddings"], 10000.0))
    return {"x": torch.randn(16, d_in, generator=gen, device=device).bfloat16(),
            "q_base": case["q"][:, 0].contiguous(), "a": a.bfloat16(), "b": b.bfloat16(),
            "ids": torch.tensor(LORA_IDS, dtype=torch.int32, device=device), "cos": cos,
            "sin": sin, "pages": list(case["pools"][0][:2]), "scales": list(case["pools"][0][2:]),
            "bt": case["bt"], "pos": case["positions"][:, 0].contiguous(),
            "operands": "synthetic: #4's 16-slot decode case"}


def fused_bitwise(torch, fa, ops: dict, out) -> dict:
    """#8 / #9's ``out`` on ``ops``: ``REPEATS`` more launches bitwise equal
    to it, and the rows of id-0 slots bitwise #4's (bf16 pages) or #5's
    (codes) output on ``q_base``.  A CPU rehearsal has no kernel to hold to
    this."""
    if out.device.type != "cuda":
        return {}
    kw = dict(k_scales=ops["scales"][0], v_scales=ops["scales"][1]) if ops["scales"] else {}
    args = [ops[k] for k in ("x", "q_base", "a", "b", "ids", "cos", "sin")] + [
        *ops["pages"], ops["bt"], ops["pos"]]
    runs = [fa.fused_bgmv_paged_decode(*args, **kw) for _ in range(REPEATS)]
    base = fa.paged_decode_attention(ops["q_base"], *ops["pages"], ops["bt"], ops["pos"], **kw)
    sync(torch)
    for i, run in enumerate(runs):
        if not torch.equal(run, out):
            raise AssertionError(f"fused decode: launch {i + 2} of {REPEATS + 1} differs from "
                                 "the first on the same operands")
    zero = ops["ids"] == 0
    if not torch.equal(out[zero], base[zero]):
        raise AssertionError("fused decode: an id-0 row differs from the decode kernel's on "
                             "q_base")
    return {"repeats_bitwise": REPEATS + 1, "id0_rows_bitwise": int(zero.sum()),
            "id0_live_rows": int((zero & (ops["pos"] >= 0)).sum())}


def fused_case(torch, F, fa, ops: dict, kv_dtype: str) -> dict:
    """#8 (bf16 pages) or #9 (int8 / fp8) on ``ops``: held against its plain
    version and against the composed route (#10, rope, #4 / #5), repeats and
    id-0 rows held bitwise (:func:`fused_bitwise`); timed in a CUDA graph
    over 4 rotating copies of the pages, beside the plain version, the
    composed route, the composed route with SDPA over the gathered pages
    and, with ``--before``, the earlier design (``before_ms``)."""
    from accelerate_tpu_torch.models.llama import apply_rope, paged_gather_kv
    from accelerate_tpu_torch.ops import lora as lora_mod

    x, q_base, a, b, ids, cos, sin = (ops[k] for k in ("x", "q_base", "a", "b", "ids", "cos",
                                                        "sin"))
    bt, pos = ops["bt"], ops["pos"]
    slots, h, d = q_base.shape
    hkv, _, page, _ = ops["pages"][0].shape
    n = bt.shape[1]
    quant = bool(ops["scales"])
    kw = dict(k_scales=ops["scales"][0], v_scales=ops["scales"][1]) if quant else {}
    kp, vp = ops["pages"]
    name = "fused_bgmv_paged_decode" + ("_quant" if quant else "")
    kernel = fa.fused_bgmv_paged_decode
    args = (x, q_base, a, b, ids, cos, sin)
    out = kernel(*args, kp, vp, bt, pos, **kw)
    sync(torch)
    ref = fa.fused_bgmv_paged_decode_plain(x, q_base.float(), a, b, ids, cos, sin, kp, vp, bt,
                                           pos, **kw)
    held = held_to_plain(torch, f"{name} {kv_dtype}", out, ref)
    bitwise = fused_bitwise(torch, fa, ops, out)
    gate = (ids != 0).float()[:, None, None]

    def composed_q():
        delta = lora_mod.bgmv(x, a, b, ids).reshape(slots, 1, h, d)
        return (q_base.float() + gate * apply_rope(delta.float(), cos, sin, pos[:, None])[:, 0]
                ).bfloat16()

    composed = fa.paged_decode_attention(composed_q(), kp, vp, bt, pos, **kw)
    held_composed = held_to_plain(torch, f"{name} {kv_dtype} vs composed", out, composed)
    pools = [(kp, vp, *ops["scales"])] + [
        tuple(t.clone() for t in (kp, vp, *ops["scales"])) for _ in range(3)]

    def rotating(fn):
        def call(i):
            pk, pv, *sc = pools[i % len(pools)]
            skw = dict(k_scales=sc[0], v_scales=sc[1]) if sc else {}
            return fn(*args, pk, pv, bt, pos, **skw)
        return call

    ms = time_ms(torch, rotating(kernel), graph=True)
    plain_ms = time_ms(torch, rotating(fa.fused_bgmv_paged_decode_plain), iters=5)
    before = {}
    if name in BEFORE:
        early = BEFORE[name](*args, kp, vp, bt, pos, **kw)
        sync(torch)
        before["before_err_over_limit"] = held_to_plain(
            torch, f"{name} {kv_dtype} (earlier design)", early, ref)["err_over_limit"]
        before["before_ms"] = time_ms(torch, rotating(BEFORE[name]), graph=True)
        del early
    composed_ms = time_ms(torch, lambda i: fa.paged_decode_attention(
        composed_q(), *pools[i % len(pools)][:2], bt, pos,
        **(dict(k_scales=pools[i % len(pools)][2], v_scales=pools[i % len(pools)][3])
           if quant else {})), graph=True)
    # yardstick: the composed route with one SDPA call over the gathered,
    # dequantized KV (set-up not timed), as #4's row times it
    k_lin, v_lin, _ = paged_gather_kv(kp, vp, bt, kw.get("k_scales"), kw.get("v_scales"),
                                      torch.bfloat16)
    k_lin = k_lin.permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1).contiguous()
    v_lin = v_lin.permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1).contiguous()
    mask = (torch.arange(n * page, device=x.device)[None, None, None, :]
            <= pos[:, None, None, None])
    idx = ids.long()

    def library(i):
        delta = torch.bmm(torch.bmm(x[:, None], a[idx]), b[idx]).reshape(slots, 1, h, d)
        q = (q_base.float() + gate * apply_rope(delta.float(), cos, sin, pos[:, None])[:, 0])
        return F.scaled_dot_product_attention(q.bfloat16()[:, :, None], k_lin, v_lin,
                                              attn_mask=mask)
    library_ms = time_ms(torch, library, graph=True)
    # what this data needs: positions and ids read, the whole output
    # written; for each live slot (position >= 0) its base q, the block-table
    # entries of its pages and each distinct live row of them once (and each
    # distinct page's scales when quantized); for each live slot
    # with a nonzero id its x, its rope row (cos and sin) and each distinct
    # id's factors once (the null slot's zeros and a dead slot's operands
    # are read by nothing the output needs)
    live = [(min(int(p) // page, n - 1) + 1) if int(p) >= 0 else 0 for p in pos.tolist()]
    read = [int(pid) for s, c in enumerate(live) for pid in bt[s, :c].tolist()]
    pages_read, kv_bytes = live_kv_bytes(torch, bt, pos, kp, quant)
    d_in, rank = a.shape[1], a.shape[2]
    adapted = [int(i) for i, c in zip(ids.tolist(), live) if c and int(i) != 0]
    n_live = sum(1 for c in live if c)
    nbytes = (slots * 8 + q_base.numel() * 2 + n_live * h * d * 2 + len(read) * 4
              + kv_bytes + len(adapted) * (d_in * 2 + d * 4)
              + len(set(adapted)) * rank * (d_in + h * d) * 2)
    flops = 4 * h * d * sum(int(p) + 1 for p in pos.tolist() if int(p) >= 0) \
        + 2 * len(adapted) * rank * (d_in + h * d)
    bound_ms, bound_by = bound(nbytes, flops)
    rep = {**held, "vs_composed": {k: held_composed[k] for k in ("max_abs_err",
                                                                 "err_over_limit")},
           "ms": ms, "plain_ms": plain_ms, "composed_ms": composed_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, **before, "bitwise": bitwise,
           "shape": {"slots": slots, "heads": h, "kv_heads": hkv, "head_dim": d, "page": page,
                     "pages_per_slot": n, "pages_read": pages_read, "kv_dtype": kv_dtype,
                     "d_in": d_in, "rank": rank, "ids": [int(i) for i in ids.tolist()],
                     "positions": [int(p) for p in pos.tolist()],
                     "operands": ops["operands"]}}
    log("kernel", name, json.dumps(rep))
    return rep


def fused_op_phase(torch, F, fa, model, trace) -> dict:
    """#8 over a bf16-page LoRA engine's operands, #9 over an int8 and an
    fp8 engine's: one launch each through ``fused_bgmv_paged_decode`` (the
    op phase's launches, counted from zero), then the checks and timings;
    then both again on #4 / #5's synthetic 16-slot case."""
    readings = {}
    for kv_dtype in ("bf16", "int8", "fp8"):
        ops = lora_decode_operands(torch, model, lora_store(torch, model), trace, kv_dtype)
        reset_counts()
        kw = dict(k_scales=ops["scales"][0], v_scales=ops["scales"][1]) if ops["scales"] else {}
        fa.fused_bgmv_paged_decode(ops["x"], ops["q_base"], ops["a"], ops["b"], ops["ids"],
                                   ops["cos"], ops["sin"], *ops["pages"], ops["bt"], ops["pos"],
                                   **kw)
        sync(torch)
        counts = launch_counts()
        name = "fused_bgmv_paged_decode" + ("_quant" if kw else "")
        expect_launches(counts, {name: 1})
        rep = fused_case(torch, F, fa, ops, kv_dtype)
        rep["launches"] = counts[name]
        readings.setdefault(name, []).append(rep)
        del ops
        torch.cuda.empty_cache()
    for kv_dtype in ("bf16", QUANT_KV):
        rep = fused_case(torch, F, fa, synthetic_fused_operands(torch, kv_dtype, model.device.type),
                         kv_dtype)
        rep["launches"] = 0
        readings["fused_bgmv_paged_decode" + ("_quant" if kv_dtype != "bf16" else "")].append(rep)
    reports = {}
    for name, cases in readings.items():
        main = next(c for c in cases if c["shape"]["kv_dtype"] in ("bf16", QUANT_KV))
        reports[name] = _with_cases(cases, main)
        reports[name]["launches"] = sum(c["launches"] for c in cases)
        reports[name]["in_path"] = {"calls": len(cases),
                                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                                    "err_over_limit": max(c["err_over_limit"] for c in cases),
                                    "vs_composed_err_over_limit": max(
                                        c["vs_composed"]["err_over_limit"] for c in cases)}
        reports[name]["library_call"] = ("composed route: gathered bmm pair, rope, "
                                         "F.scaled_dot_product_attention over the gathered KV")
        reports[name]["ptxas"] = FUSED_PTXAS
    return reports


# -- phase memory_recipes: remat and the scanned stack, fp16, fp8, offload ----

# bench.py's _1b_config (1.34 B parameters at 24 layers, sized for a
# resident train state with remat)
MEM_1B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
              num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
              max_position_embeddings=2048)
MEM = dict(batch=3, seq=2048, warmup=2, timed=3, ce_chunks=4, optimizer="lion-sr8",
           boundary_fraction=0.5, scan_loss_rtol=1e-3)
MEM_FP16 = dict(warmup=2, timed=3, optimizer="lion")
MEM_FP8 = dict(warmup=2, timed=5, loss_rtol=0.05, optimizer="lion-sr")
# one step a configuration: the offloaded host updates take 8-17 s a step
MEM_OFFLOAD = dict(steps=1, chunk_gib=0.25, optimizer="lion-sr8")
# the 600m model's dense shapes (in, out), as fp8 products at the step's rows
FP8_SHAPES = {"q_proj / o_proj": (1536, 1536), "k_proj / v_proj": (1536, 768),
              "gate_proj / up_proj": (1536, 4096), "down_proj": (4096, 1536)}
FP8_MM_RTOL = 1e-3
F16_CASES = [dict(name="f16_causal", t=2048), dict(name="f16_segments", t=2048, seg=True),
             dict(name="f16_positions", t=2048, pos=True),
             dict(name="f16_t_not_tile_multiple", t=2000)]


def mem_batch(torch, vocab: int, batch: int, seed: int = 0) -> dict:
    tokens = np.random.default_rng(seed).integers(0, vocab, (batch, MEM["seq"]))
    ids = torch.from_numpy(tokens).cuda()
    return {"input_ids": ids, "labels": ids}


def flash_counts(fa) -> dict:
    return {n: getattr(fa, n).launches for n in FLASH_REPLACES}


def peak_sites(torch, fn, top: int = 6) -> dict:
    """Run ``fn`` (one train step) under the allocator's history: the
    step's own peak above what was live before it, and what was live at
    that moment by the port's source line that allocated it (GiB; a block
    allocated under no frame of the port, a gradient of autograd's engine
    for one, counts as ``autograd``)."""
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        fn()
        sync(torch)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
            cur -= ev["size"]
    sites: dict = {}
    for ev in at_peak.values():
        frame = next((f for f in ev.get("frames", [])
                      if "accelerate_tpu_torch" in f["filename"]), None)
        where = (f"{Path(frame['filename']).name}:{frame['line']} {frame['name']}"
                 if frame else "autograd")
        sites[where] = sites.get(where, 0) + ev["size"]
    ranked = sorted(sites.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_gib": peak / 2**30, "sites_gib": {w: n / 2**30 for w, n in ranked}}


def held_loss_fn(torch, loss_fn, held: list):
    """``loss_fn`` that records the device memory its forward left
    allocated (the activations the backward will read)."""
    def fn(params, batch):
        base = torch.cuda.memory_allocated()
        loss = loss_fn(params, batch)
        held.append(torch.cuda.memory_allocated() - base)
        return loss
    return fn


def opt_tensors(state) -> list:
    """The optimizer state's tensors (codes, scales, moments) in field
    order."""
    return [t for field in state.opt_state if isinstance(field, list) for t in field]


def all_equal(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y.to(x.device))
                                    for x, y in zip(a, b))


def remat_1b_case(torch, fa, card: str) -> dict:
    """(a) the 1.34B step under remat off / full / dots and the scanned
    stack with offloaded boundaries, every run from one seeded state."""
    import dataclasses

    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn,
    )
    from accelerate_tpu_torch.models.llama import (
        boundary_offload_rows, count_params, flops_per_token, stack_layer_params,
    )

    cfg0 = LlamaConfig(**MEM_1B, attn_implementation="flash", dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg0, device="cuda", seed=0)
    start = {n: p.detach().to(torch.bfloat16).clone() for n, p in model.named_parameters()}
    n_params = count_params(start)
    layers, b, t = cfg0.num_hidden_layers, MEM["batch"], MEM["seq"]
    batch = mem_batch(torch, cfg0.vocab_size, b)
    fpt = flops_per_token(cfg0, t)
    held: list = []
    loss_fn = held_loss_fn(torch, make_llama_loss_fn(model, fused_vocab_chunks=MEM["ce_chunks"]),
                           held)
    runs, ref = {}, None
    for policy in (None, "full", "dots"):
        label = policy or "off"
        model.config = dataclasses.replace(cfg0, remat=policy is not None,
                                           remat_policy=policy or "full")
        acc = Accelerator(mixed_precision="bf16", device="cuda",
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        state = acc.create_train_state({n: x.clone() for n, x in start.items()},
                                       MEM["optimizer"])
        step = acc.prepare_train_step(loss_fn)
        losses = []
        for _ in range(MEM["warmup"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        snap = [p.clone() for p in state.params.values()] + [x.clone() for x in opt_tensors(state)]
        if ref is None:
            ref = snap
        elif not all_equal(torch, snap, ref):
            raise AssertionError(f"remat {label}: params, codes or scales after "
                                 f"{MEM['warmup']} steps differ from remat off's")
        del snap
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        held.clear()
        t0 = time.perf_counter()
        for _ in range(MEM["timed"]):
            state, m = step(state, batch)
            losses.append(m["loss"])
        sync(torch)
        step_s = (time.perf_counter() - t0) / MEM["timed"]
        counts = flash_counts(fa)
        losses = [float(x) for x in losses]
        want = {"flash_fwd": (2 if policy else 1) * layers, "flash_dq": layers,
                "flash_dkv": layers}
        per_step = {n: c / MEM["timed"] for n, c in counts.items()}
        if per_step != want:
            raise AssertionError(f"remat {label}: #1-#3 launches a step {per_step}, want {want}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"remat {label}: losses not finite and falling: {losses}")
        PATH_LAUNCHES[f"memory_1b_remat_{label}"] = counts
        runs[label] = {"step_ms": step_s * 1e3, "tokens_per_s": b * t / step_s,
                       "mfu_vs_989_tflops": fpt * b * t / step_s / BF16_FLOPS_PER_S,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       # the step's own peak above what was live before it
                       "step_peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                       "forward_held_gib": max(held) / 2**30, "launches_per_step": per_step,
                       "losses": losses}
        if policy == "full":
            runs[label]["peak_sites"] = peak_sites(torch, lambda: step(state, batch))
        log("memory_recipes remat", label, json.dumps(runs[label]))
        del state, step, acc, m
        torch.cuda.empty_cache()
    # the scanned stack, its boundaries' head half on the host, alone on the
    # card with its weights
    sparams = stack_layer_params({n: x.clone() for n, x in start.items()})
    del ref, model, start, loss_fn
    torch.cuda.empty_cache()
    scfg = dataclasses.replace(cfg0, scan_layers=True, remat=True, remat_policy="offload",
                               boundary_offload_fraction=MEM["boundary_fraction"])
    smodel = LlamaForCausalLM(scfg, device="cuda", seed=0)
    acc = Accelerator(mixed_precision="bf16", device="cuda",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    state = acc.create_train_state(sparams, MEM["optimizer"])
    step = acc.prepare_train_step(held_loss_fn(
        torch, make_llama_loss_fn(smodel, fused_vocab_chunks=MEM["ce_chunks"]), held))
    losses = []
    for _ in range(MEM["warmup"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    # timed as the unrolled runs are: after the warm steps, its own peak
    # above what was live before the timed steps
    held.clear()
    fa.reset_launch_counts()
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    smodel.boundary_stats.update(d2h_bytes=0, h2d_bytes=0)
    t0 = time.perf_counter()
    for _ in range(MEM["timed"]):
        state, m = step(state, batch)
    sync(torch)
    step_s = (time.perf_counter() - t0) / MEM["timed"]
    counts = flash_counts(fa)
    PATH_LAUNCHES["memory_scan_offload"] = counts
    rows = boundary_offload_rows(t, MEM["boundary_fraction"])
    predicted = layers * b * rows * cfg0.hidden_size * 2
    full = runs["full"]
    scan = {"step_ms": step_s * 1e3, "losses": losses,
            "d2h_bytes_per_step": smodel.boundary_stats["d2h_bytes"] / MEM["timed"],
            "h2d_bytes_per_step": smodel.boundary_stats["h2d_bytes"] / MEM["timed"],
            "d2h_bytes_predicted": predicted, "host_rows": rows,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "forward_held_gib": max(held) / 2**30,
            "launches_per_step": {n: c / MEM["timed"] for n, c in counts.items()},
            "peak_sites": peak_sites(torch, lambda: step(state, batch))}
    log("memory_recipes scan_offload", json.dumps(scan))
    if losses[0] != full["losses"][0]:
        raise AssertionError(f"scan + offload: first loss {losses[0]} != the unrolled full "
                             f"run's {full['losses'][0]}")
    if abs(losses[1] - full["losses"][1]) > MEM["scan_loss_rtol"] * abs(full["losses"][1]):
        raise AssertionError(f"scan + offload: second loss {losses[1]} off the unrolled "
                             f"run's {full['losses'][1]}")
    if scan["d2h_bytes_per_step"] != predicted or scan["h2d_bytes_per_step"] != predicted:
        raise AssertionError(f"scan + offload: boundary bytes {scan} != predicted {predicted}")
    if not scan["step_peak_gib"] < full["step_peak_gib"]:
        raise AssertionError(f"scan + offload: the step's peak {scan['step_peak_gib']} GiB is "
                             f"not below full remat's {full['step_peak_gib']}")
    del state, step, acc, smodel, sparams
    torch.cuda.empty_cache()
    return {"card": card, "params": n_params, "batch": b, "seq": t, "runs": runs,
            "scan_offload": scan}


def flash_f16_checks(torch, F, fa) -> dict:
    """#1-#3's f16 instances against their plain versions at batch 2
    (causal, segments, positions, T not a multiple of the tile) and at
    batch 10, #2 / #3 repeated 21 times bitwise; each timed beside its
    bf16 instance and SDPA's f16 call (a yardstick)."""
    d = FLASH_HEADS["d"]
    readings = {name: [] for name in FLASH_REPLACES}
    for i, case in enumerate(F16_CASES):
        q, k, v, g, g_lse, kw = flash_inputs(torch, b=CHECK_BATCH, t=case["t"],
                                             seg=case.get("seg", False),
                                             pos=case.get("pos", False), seed=300 + i,
                                             dtype=torch.float16)
        got = flash_fwd_bwd(torch, fa.flash_attention, q, k, v, g, g_lse, True, kw)
        sync(torch)
        want = flash_fwd_bwd(torch, fa.flash_attention_plain, q, k, v, g, g_lse, True, kw)
        rep = {}
        for label, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if x.dtype != ref.dtype:
                raise AssertionError(f"flash {case['name']} {label}: {x.dtype} != {ref.dtype}")
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            rep[label] = held_to_plain(torch, f"flash {case['name']} {label}", x, ref,
                                       slack=half_ulp_f16(torch, ref)
                                       if label in ("dq", "dk", "dv") else None,
                                       tol=KERNEL_TOL_F16, row_floor=ROW_SCALE_FLOOR_F16)
        log("kernel flash", case["name"], json.dumps(rep))
        for name, labels in (("flash_fwd", ("out", "lse")), ("flash_dq", ("dq",)),
                             ("flash_dkv", ("dk", "dv"))):
            readings[name] += [dict(rep[lb], case=case["name"], tensor=lb) for lb in labels]
        del got, want
    b, seq = TRAIN["batch"], TRAIN["seq"]
    kw = dict(causal=True, sm_scale=d ** -0.5)
    ops = {}
    for dtype in (torch.float16, torch.bfloat16):
        q, k, v, g, _, _ = flash_inputs(torch, b=b, t=seq, seed=7, dtype=dtype)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        ops[dtype] = (q, k, v, g, out, lse, delta)
    q, k, v, g, out, lse, delta = ops[torch.float16]
    dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
    dkv = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    for name, first in (("flash_dq", (dq,)), ("flash_dkv", dkv)):
        fn = getattr(fa, name)
        runs = [fn(q, k, v, g, lse, delta, **kw) for _ in range(REPEATS)]
        sync(torch)
        for i, run in enumerate(runs):
            run = run if isinstance(run, tuple) else (run,)
            if not all(torch.equal(x, y) for x, y in zip(first, run)):
                raise AssertionError(f"{name} f16: launch {i + 2} of {REPEATS + 1} differs "
                                     "from the first on the same operands")
        del runs
    for name, got, plain, labels in (
        ("flash_fwd", (out, lse), lambda: fa.flash_fwd_plain(q, k, v, **kw), ("out", "lse")),
        ("flash_dq", (dq,), lambda: (fa.flash_dq_plain(q, k, v, g, lse, delta, **kw),), ("dq",)),
        ("flash_dkv", dkv, lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw),
         ("dk", "dv")),
    ):
        for label, x, ref in zip(labels, got, plain()):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            r = held_to_plain(torch, f"flash f16 B {b} {label}", x, ref,
                              slack=half_ulp_f16(torch, ref) if label in ("dq", "dk", "dv")
                              else None, tol=KERNEL_TOL_F16, row_floor=ROW_SCALE_FLOOR_F16)
            readings[name].append(dict(r, case=f"f16_causal_b{b}", tensor=label))
    del dq, dkv
    ms = {}
    for dtype, tag in ((torch.float16, "f16"), (torch.bfloat16, "bf16")):
        q, k, v, g, out, lse, delta = ops[dtype]
        ms[tag] = {"flash_fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v, **kw)),
                   "flash_dq": time_ms(torch, lambda i: fa.flash_dq(q, k, v, g, lse, delta, **kw)),
                   "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv(q, k, v, g, lse, delta,
                                                                      **kw))}
    q, k, v, g = ops[torch.float16][:4]
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gs = g.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda i: sdpa())
    out_s = sdpa()
    sdpa_bwd = time_ms(torch, lambda i: torch.autograd.grad(out_s, (qs, ks, vs), gs,
                                                           retain_graph=True))
    del out_s, ops
    pairs = b * FLASH_HEADS["h"] * seq * (seq + 1) // 2
    bounds = flash_bound(b, seq, pairs)
    reports = {}
    for name in FLASH_REPLACES:
        worst = max(readings[name], key=lambda r: r["err_over_limit"])
        reports[name] = {"max_abs_err": max(r["max_abs_err"] for r in readings[name]),
                         "err_over_limit": worst["err_over_limit"], "worst": worst,
                         "ms": ms["f16"][name], "bf16_ms": ms["bf16"][name],
                         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                         "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
                         "cases": [c["name"] for c in F16_CASES] + [f"f16_causal_b{b}"]}
        log("kernel", name, "f16", json.dumps(reports[name]))
    torch.cuda.empty_cache()
    return reports


def fp16_case(torch, F, fa, card: str) -> dict:
    """(b) the 600m step under fp16: f16 model, f32 masters, dynamic loss
    scaling; an injected overflow; #1-#3's f16 instances."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn

    cfg = LlamaConfig(**MODEL, dtype=torch.float16)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    params = {n: p.detach().float() for n, p in model.named_parameters()}
    acc = Accelerator(mixed_precision="fp16", device="cuda")
    state = acc.create_train_state(params, MEM_FP16["optimizer"])
    base = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    step = acc.prepare_train_step(lambda p, batch: base(p, batch) * batch["k"])
    batch = {**token_batch(torch, cfg.vocab_size, TRAIN["batch"]),
             "k": torch.ones((), device="cuda")}
    losses, scales, finite = [], [], []
    fa.reset_launch_counts()
    times = []
    for _ in range(MEM_FP16["warmup"] + MEM_FP16["timed"]):
        sync(torch)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        scales.append(float(m["loss_scale"]))
        finite.append(bool(m["grads_finite"]))
    counts = flash_counts(fa)
    PATH_LAUNCHES["memory_fp16"] = counts
    steps = MEM_FP16["warmup"] + MEM_FP16["timed"]
    layers = cfg.num_hidden_layers
    if counts != {n: steps * layers for n in FLASH_REPLACES}:
        raise AssertionError(f"fp16: #1-#3 (f16) launched {counts} in {steps} steps")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] \
            or not any(finite):
        raise AssertionError(f"fp16: losses {losses} (finite steps {finite}) not finite and "
                             "falling")
    before = ([p.clone() for p in state.params.values()], [x.clone() for x in opt_tensors(state)],
              state.opt_state.count, float(state.loss_scale.scale))
    state, m = step(state, {**batch, "k": torch.full((), float("inf"), device="cuda")})
    if bool(m["grads_finite"]) or float(m["loss_scale"]) != before[3] / 2:
        raise AssertionError(f"fp16: the injected overflow was not caught: {m}")
    if not (all_equal(torch, list(state.params.values()), before[0])
            and all_equal(torch, opt_tensors(state), before[1])
            and state.opt_state.count == before[2]):
        raise AssertionError("fp16: the overflowed step changed params or optimizer state")
    rep = {"card": card, "optimizer": MEM_FP16["optimizer"], "losses": losses,
           "loss_scale": scales, "grads_finite": finite,
           "step_ms": 1e3 * sum(times[MEM_FP16["warmup"]:]) / MEM_FP16["timed"],
           "overflow_step": {"grads_finite": False, "scale_after": float(m["loss_scale"]),
                             "state_bitwise_unchanged": True},
           "launches_per_step": {n: c / steps for n, c in counts.items()}}
    log("memory_recipes fp16", json.dumps(rep))
    del state, step, acc, params, model, before
    torch.cuda.empty_cache()
    rep["kernels_f16"] = flash_f16_checks(torch, F, fa)
    return rep


def fp8_gemm_checks(torch, F) -> dict:
    """Each fp8 product of the dense layers at the 600m shapes and the
    step's rows, ``torch._scaled_mm`` against its plain version on the same
    codes: forward e4m3 x e4m3, backward dx and dw e5m2 x e4m3."""
    from accelerate_tpu_torch.ops import precision as prec

    m_rows = TRAIN["batch"] * TRAIN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for label, (k_in, n_out) in FP8_SHAPES.items():
        x = torch.randn(m_rows, k_in, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(n_out, k_in, generator=gen, device="cuda") / k_in ** 0.5).bfloat16()
        g = torch.randn(m_rows, n_out, generator=gen, device="cuda").bfloat16()
        xs = prec._over(prec.E4M3_MAX, x.float().abs().amax())
        ws = prec._over(prec.E4M3_MAX, w.float().abs().amax())
        gs = prec._over(prec.E5M2_MAX, g.float().abs().amax())
        qx = prec.saturate_cast(x, xs, prec.E4M3_MAX, torch.float8_e4m3fn)
        qw = prec.saturate_cast(w.t(), ws, prec.E4M3_MAX, torch.float8_e4m3fn)
        qg = prec.saturate_cast(g, gs, prec.E5M2_MAX, torch.float8_e5m2)
        products = {"fwd_e4m3_e4m3": (qx, qw, xs * ws), "dx_e5m2_e4m3": (qg, qw.t(), gs * ws),
                    "dw_e5m2_e4m3": (qg.t(), qx, xs * gs)}
        rep = {}
        for name, (a, bm, descale) in products.items():
            # held in f32, each row to FP8_MM_RTOL of its largest |value|:
            # the fp8 tensor cores accumulate at less than f32's width
            # between cuBLASLt's promotions to f32; the plain version's f32
            # sums would part from another f32 order by far less
            got = prec.fp8_mm(a, bm, descale, torch.float32)
            ref = prec.fp8_mm_plain(a, bm, descale, torch.float32)
            row_err = (got - ref).abs().amax(dim=1)
            row_ref = ref.abs().amax(dim=1).clamp(min=1e-30)
            worst = (row_err / row_ref).max().item()
            if not (bool(torch.isfinite(got).all()) and worst <= FP8_MM_RTOL):
                raise AssertionError(f"fp8 {label} {name}: off its plain version by {worst} of "
                                     "a row's largest value")
            mm, nn = got.shape
            kk = a.shape[1]
            rep[name] = {"shape": [mm, kk, nn], "max_abs_err": (got - ref).abs().max().item(),
                         "err_over_row_max": worst,
                         "ms": time_ms(torch, lambda i: prec.fp8_mm(a, bm, descale,
                                                                    torch.bfloat16)),
                         "plain_ms": time_ms(torch, lambda i: prec.fp8_mm_plain(
                             a, bm, descale, torch.bfloat16), iters=3, warmup=1),
                         "bound_ms": bound(mm * kk + kk * nn + 2 * mm * nn, 2 * mm * kk * nn)[0]}
        rep["bf16_linear_ms"] = time_ms(torch, lambda i: F.linear(x, w))
        out[label] = rep
        del x, w, g, qx, qw, qg
    log("memory_recipes fp8 products", json.dumps(out))
    return out


def fp8_case(torch, F, fa, card: str) -> dict:
    """(c) the 600m step under fp8 delayed scaling beside bf16 over the
    same batches, then the fp8 products at the dense shapes."""
    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn,
    )
    from accelerate_tpu_torch.ops import precision as prec

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    start = {n: p.detach().to(torch.bfloat16).clone() for n, p in model.named_parameters()}
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    batch = token_batch(torch, cfg.vocab_size, TRAIN["batch"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    runs = {}
    for mp in ("bf16", "fp8"):
        acc = Accelerator(mixed_precision=mp, device="cuda",
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        if acc.mixed_precision != mp:
            raise AssertionError(f"mixed_precision {mp!r} resolved to {acc.mixed_precision!r}")
        state = acc.create_train_state({n: x.clone() for n, x in start.items()},
                                       MEM_FP8["optimizer"])
        if mp == "fp8" and not state.fp8_state:
            raise AssertionError("fp8: no delayed-scaling metas in the train state")
        step = acc.prepare_train_step(loss_fn)
        losses = []
        for _ in range(MEM_FP8["warmup"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        sync(torch)
        fa.reset_launch_counts()
        prec.fp8_mm.launches = 0
        t0 = time.perf_counter()
        for _ in range(MEM_FP8["timed"]):
            state, m = step(state, batch)
            losses.append(m["loss"])
        sync(torch)
        step_s = (time.perf_counter() - t0) / MEM_FP8["timed"]
        counts = flash_counts(fa)
        PATH_LAUNCHES[f"memory_{mp}_600m" if mp == "bf16" else "memory_fp8"] = counts
        runs[mp] = {"losses": [float(x) for x in losses], "step_ms": step_s * 1e3,
                    "tokens_per_s": tokens / step_s,
                    "fp8_products_per_step": prec.fp8_mm.launches / MEM_FP8["timed"],
                    "launches_per_step": {n: c / MEM_FP8["timed"] for n, c in counts.items()}}
        if mp == "fp8":
            runs[mp]["metas"] = len(state.fp8_state)
        log("memory_recipes", mp, json.dumps(runs[mp]))
        del state, step, acc, m
        torch.cuda.empty_cache()
    bf16, fp8 = runs["bf16"]["losses"], runs["fp8"]["losses"]
    if not all(math.isfinite(x) for x in fp8) or any(
            abs(a - b) > MEM_FP8["loss_rtol"] * abs(b) for a, b in zip(fp8, bf16)):
        raise AssertionError(f"fp8 losses {fp8} off bf16's {bf16}")
    if runs["fp8"]["fp8_products_per_step"] != 3 * 7 * cfg.num_hidden_layers:
        raise AssertionError(f"fp8: {runs['fp8']['fp8_products_per_step']} fp8 products a "
                             "step, want 3 for each of the 7 denses of every layer")
    del model, start
    torch.cuda.empty_cache()
    return {"card": card, "runs": runs, "products": fp8_gemm_checks(torch, F)}


def offload_case(torch, fa, card: str) -> dict:
    """(d) the 600m step under ZeRO-offload with lion-sr8: resident, then
    the monolithic, chunked serial and chunked pipelined host updates,
    ``MEM_OFFLOAD["steps"]`` steps each from one state."""
    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn,
    )
    from accelerate_tpu_torch.models.llama import count_params
    from accelerate_tpu_torch.ops.streaming import offload_transfer_accounting
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    start = {n: p.detach().to(torch.bfloat16).clone() for n, p in model.named_parameters()}
    n_params = count_params(start)
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    batch = token_batch(torch, cfg.vocab_size, TRAIN["batch"])
    predicted = offload_transfer_accounting(n_params, optimizer=MEM_OFFLOAD["optimizer"])
    runs, snaps = {}, {}
    for label, chunk, pipeline in (("resident", None, None), ("monolithic", None, False),
                                   ("chunked_serial", MEM_OFFLOAD["chunk_gib"], False),
                                   ("chunked_pipelined", MEM_OFFLOAD["chunk_gib"], True)):
        plugin = None if label == "resident" else FullyShardedDataParallelPlugin(
            cpu_offload=True, offload_params=True, host_update_chunk_gib=chunk,
            host_update_pipeline=pipeline)
        acc = Accelerator(mixed_precision="bf16", device="cuda", fsdp_plugin=plugin,
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        t0 = time.perf_counter()
        state = acc.create_train_state({n: x.clone() for n, x in start.items()},
                                       MEM_OFFLOAD["optimizer"])
        setup_s = time.perf_counter() - t0
        step = acc.prepare_train_step(loss_fn)
        fa.reset_launch_counts()
        rep = {"setup_s": setup_s, "steps": []}
        for _ in range(MEM_OFFLOAD["steps"]):
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            rep["steps"].append({"step_ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                                 **{k: v for k, v in acc.offload_log.items()}})
            if plugin is not None and (acc.offload_log["d2h_bytes"] != predicted["d2h_bytes"]
                                       or acc.offload_log["h2d_bytes"] != predicted["h2d_bytes"]):
                raise AssertionError(f"offload {label}: bytes {acc.offload_log} != predicted "
                                     f"{predicted}")
        PATH_LAUNCHES[f"memory_offload_{label}"] = flash_counts(fa)
        snaps[label] = [p.detach().to("cpu", copy=True) for p in state.params.values()] + \
            [x.detach().to("cpu", copy=True) for x in opt_tensors(state)]
        runs[label] = rep
        log("memory_recipes offload", label, json.dumps(rep))
        del state, step, acc
        torch.cuda.empty_cache()
    if not all_equal(torch, snaps["monolithic"], snaps["resident"]):
        raise AssertionError("offload: the monolithic host update differs from the resident "
                             "one (params, codes or scales)")
    if not all_equal(torch, snaps["chunked_pipelined"], snaps["chunked_serial"]):
        raise AssertionError("offload: the pipelined chunked update differs from the serial "
                             "one")
    del snaps, model, start
    torch.cuda.empty_cache()
    return {"card": card, "params": n_params, "predicted": predicted, "runs": runs,
            "threads": torch.get_num_threads()}


def memory_recipes_phase(torch, F, fa, card: str) -> dict:
    """The memory and precision recipes (the module docstring's step 6b)."""
    t0 = time.perf_counter()
    out = {"remat_1b": remat_1b_case(torch, fa, card)}
    out["fp16"] = fp16_case(torch, F, fa, card)
    out["fp8"] = fp8_case(torch, F, fa, card)
    out["offload"] = offload_case(torch, fa, card)
    out["seconds"] = time.perf_counter() - t0
    summary = {
        "card": card,
        "remat_1b": {k: {kk: v[kk] for kk in ("step_ms", "mfu_vs_989_tflops", "peak_gib",
                                              "step_peak_gib", "forward_held_gib")}
                     for k, v in out["remat_1b"]["runs"].items()},
        "scan_offload": {k: out["remat_1b"]["scan_offload"][k] for k in (
            "step_ms", "peak_gib", "step_peak_gib", "forward_held_gib", "d2h_bytes_per_step")},
        "fp16_losses": out["fp16"]["losses"], "fp16_loss_scale": out["fp16"]["loss_scale"],
        "fp8_vs_bf16_tokens_per_s": [out["fp8"]["runs"]["fp8"]["tokens_per_s"],
                                     out["fp8"]["runs"]["bf16"]["tokens_per_s"]],
        "offload_step_ms": {k: [s["step_ms"] for s in v["steps"]]
                            for k, v in out["offload"]["runs"].items()},
        "seconds": out["seconds"]}
    log("memory_recipes", json.dumps(summary))
    return out


# -- multi-tenant LoRA fine-tuning (LoraTrainer) ------------------------------

# the 600m base frozen, 8 tenants' rank-16 q / v adapters over a pool of 4,
# a batch of 8 rows x 1024 tokens: one base row, tenants 1-4 in the rest,
# tenants 5-8 take no rows.  lion-sr8 at lr 1e-3: at the recipe's default
# 1e-4 a fresh adapter's delta stays under a bf16 step of the q / v outputs
# for the 5 steps, so the bf16 sums round it away and the loss cannot fall
LORA_TRAIN = dict(batch=8, seq=1024, steps=5, tenants=8, rank=16, pool_slots=4, lr=1e-3,
                  ids=[1, 2, 3, 4, 0, 1, 2, 3], loss_rtol=1e-2, grad_rtol=5e-2)


def grad_rel_err(grads: dict, ref: dict) -> float:
    """The worst ``|g - ref| / |ref|`` (Frobenius norms) over the tenants
    and leaves of two ``{tenant: {module: {"a", "b"}}}`` gradient trees."""
    return max(float((grads[t][n][f] - ref[t][n][f]).norm() / ref[t][n][f].norm())
               for t in ref for n in ref[t] for f in ("a", "b"))


def profiled_step(torch, step, top: int = 8) -> dict:
    """One call of ``step`` under ``torch.profiler`` (CPU and CUDA
    activity), ended by a device sync: its wall ms under the profiler, the
    device ms its kernels took and their share of the wall, the number of
    device kernels, and the ``top`` device items by self time."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        sync(torch)
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the device's own events (kernels, copies, sets): an operator's entry
    # carries the time of the kernels it launched as well, counted once here
    items = [(e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
             if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(ms for _, ms, _ in items)
    items.sort(key=lambda x: -x[1])
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy": device_ms / wall_ms if wall_ms else 0.0,
            "kernels": sum(n for _, _, n in items),
            "top": [{"name": k[:80], "ms": ms, "calls": n} for k, ms, n in items[:top]]}


def lora_train_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """``LoraTrainer`` on the 600m model at full width and depth (module
    docstring, step 6c)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, LoraPlugin
    from accelerate_tpu_torch.checkpointing import CheckpointCorruptError
    from accelerate_tpu_torch.ops.lora import adapter_state_accounting
    from accelerate_tpu_torch.serving import LoraTrainer
    from accelerate_tpu_torch.serving.adapters import _state_tensors

    lt = LORA_TRAIN
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    plugin = LoraPlugin(rank=lt["rank"], pool_slots=lt["pool_slots"],
                        targets=LORA["targets"], kernel=LORA["kernel"])
    trainer = LoraTrainer(model, plugin, learning_rate=lt["lr"])
    tenants = list(range(1, lt["tenants"] + 1))
    for t in tenants:
        trainer.add_adapter(t)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (lt["batch"], lt["seq"]))
    ids_t = torch.from_numpy(tokens).to(device)
    batch = {"input_ids": ids_t, "labels": ids_t}
    ids = lt["ids"]
    idle = [t for t in tenants if t not in ids]

    def leaves(tr, t):
        return list(tr._flat(tr.adapters[t])) + list(_state_tensors(tr.opt_states[t]))

    idle_before = {t: [x.clone() for x in leaves(trainer, t)] for t in idle}
    seq_loss_1 = trainer.sequential_loss(batch, ids)
    layers = cfg.num_hidden_layers
    sync(torch)
    fa.reset_launch_counts()
    losses, step_ms, park, unpark = [], [], [], []
    for _ in range(lt["steps"]):
        t0 = time.perf_counter()
        losses.append(trainer.step(batch, ids))
        sync(torch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        park.append(trainer.step_log["park_ms"])
        unpark.append(trainer.step_log["unpark_ms"])
    launches = flash_counts(fa)
    moved = dict(trainer.step_log)
    for name, count in launches.items():
        if count != lt["steps"] * layers:
            raise AssertionError(f"lora_train: {name} launched {count} times in {lt['steps']} "
                                 f"steps, expected {layers} per step")
    if not (all(math.isfinite(x) for x in losses)
            and (losses[-1] + losses[-2]) / 2 < losses[0]):
        raise AssertionError(f"lora_train losses not finite and falling: {losses}")
    if abs(losses[0] - seq_loss_1) > lt["loss_rtol"] * abs(seq_loss_1):
        raise AssertionError(f"lora_train: step 1's batched loss {losses[0]} against the "
                             f"sequential schedule's {seq_loss_1}")
    for t in idle:
        if not all_equal(torch, idle_before[t], leaves(trainer, t)):
            raise AssertionError(f"lora_train: tenant {t} took no rows but its weights or "
                                 "optimizer state moved")
    # at trained adapters (step 1's b factors are zeros, so its loss pin
    # cannot see the routing): each tenant's slice of the batched gradients
    # against a backward over its rows alone, and the same comparison
    # against two faulty schedules, which must fail it: tenants 1-3's
    # second rows dropped (a gathered-index backward that loses rows
    # sharing a slot) and tenants' gradients swapped (a mis-routed pool)
    loss_now, grads = trainer.tenant_grads(batch, ids)
    seq_now = trainer.sequential_loss(batch, ids)
    if abs(loss_now - seq_now) > lt["loss_rtol"] * abs(seq_now):
        raise AssertionError(f"lora_train: trained batched loss {loss_now} against the "
                             f"sequential schedule's {seq_now}")
    seq_grads = trainer.sequential_grads(batch, ids)
    first_rows = [t if t not in ids[:i] else 0 for i, t in enumerate(ids)]
    routed = sorted(seq_grads)
    grad_check = {
        "tenants": grad_rel_err(grads, seq_grads),
        "rows_dropped": grad_rel_err(grads, trainer.sequential_grads(batch, first_rows)),
        "tenants_swapped": grad_rel_err(grads, {t: seq_grads[u] for t, u in
                                                zip(routed, routed[1:] + routed[:1])}),
        "limit": lt["grad_rtol"]}
    log("lora_train_grad_check", json.dumps(grad_check))
    if grad_check["tenants"] > lt["grad_rtol"]:
        raise AssertionError(f"lora_train: tenant gradients off the sequential schedule's "
                             f"by {grad_check['tenants']} > {lt['grad_rtol']}")
    if min(grad_check["rows_dropped"], grad_check["tenants_swapped"]) <= lt["grad_rtol"]:
        raise AssertionError(f"lora_train: the gradient gate does not see a faulty "
                             f"schedule: {grad_check}")
    del grads, seq_grads

    # the verified checkpoint: bitwise round trip, bitwise continuation, a
    # torn shard refused
    root = Path(tempfile.mkdtemp(prefix="lora_train_"))
    try:
        t0 = time.perf_counter()
        trainer.save(str(root / "ck"))
        save_ms = (time.perf_counter() - t0) * 1e3
        restored = LoraTrainer(model, plugin, learning_rate=lt["lr"])
        t0 = time.perf_counter()
        if restored.load(str(root / "ck")) != tenants:
            raise AssertionError("lora_train: the restore missed tenants")
        load_ms = (time.perf_counter() - t0) * 1e3
        for t in tenants:
            if not all_equal(torch, leaves(trainer, t), leaves(restored, t)) or \
                    trainer.opt_states[t].count != restored.opt_states[t].count:
                raise AssertionError(f"lora_train: tenant {t} not bitwise after save / load")
        next_a, next_b = trainer.step(batch, ids), restored.step(batch, ids)
        if next_a != next_b:
            raise AssertionError(f"lora_train: the restored trainer's next loss {next_b} is "
                                 f"not the saved one's {next_a}")
        shard = sorted((root / "ck").glob("adapter_*.npz"))[0]
        shard.write_bytes(shard.read_bytes()[:-16])
        try:
            LoraTrainer(model, plugin, learning_rate=lt["lr"]).load(str(root / "ck"))
        except CheckpointCorruptError:
            pass
        else:
            raise AssertionError("lora_train: a truncated shard loaded")
        ck_bytes = sum(f.stat().st_size for f in (root / "ck").iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del restored

    # one step with every #1-#3 launch held to its plain version
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        trainer.step(batch, ids)
    in_path = worst_of(readings, {n: layers for n in FLASH_REPLACES})
    log("lora_train_in_path", json.dumps(in_path))
    breakdown = profiled_step(torch, lambda: trainer.step(batch, ids))
    log("lora_train_profile", json.dumps(breakdown))

    report = trainer.host_state_report()
    predicted = adapter_state_accounting(trainer.spec, lt["rank"], lt["tenants"],
                                         optimizer=plugin.optimizer)
    steady = step_ms[1:]
    tokens_per_step = lt["batch"] * lt["seq"]
    rep = {"card": card, "batch": lt["batch"], "seq": lt["seq"], "tenants": lt["tenants"],
           "ids": ids, "rank": lt["rank"], "pool_slots": lt["pool_slots"],
           "optimizer": plugin.optimizer, "lr": lt["lr"], "losses": losses, "sequential_loss_step1": seq_loss_1,
           "grad_check": grad_check,
           "step_ms": step_ms, "step_ms_median_steps_2_5": float(np.median(steady)),
           "tokens_per_s": tokens_per_step / (float(np.median(steady)) / 1e3),
           "unpark_ms": unpark, "park_ms": park, "h2d_bytes_per_step": moved["h2d_bytes"],
           "d2h_bytes_per_step": moved["d2h_bytes"], "launches_per_step": {
               n: c / lt["steps"] for n, c in launches.items()},
           "save_ms": save_ms, "load_ms": load_ms, "checkpoint_bytes": ck_bytes,
           "host_state_report": report, "adapter_state_accounting": predicted,
           "profile": {k: breakdown[k] for k in ("wall_ms", "device_ms", "device_busy",
                                                  "kernels")}}
    log("lora_train", json.dumps(rep))
    log(f"lora_train on {card}: {rep['step_ms_median_steps_2_5']:.1f} ms/step, "
        f"{rep['tokens_per_s']:.0f} tokens/s, host unpark {np.median(unpark):.2f} ms + park "
        f"{np.median(park):.2f} ms a step; host state {report['weight_bytes']} weight + "
        f"{report['state_bytes']} state bytes (predicted "
        f"{predicted['weight_bytes_per_adapter'] * lt['tenants']} + "
        f"{predicted['state_bytes_per_adapter'] * lt['tenants']})")
    del trainer, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "in_path": in_path, "report": rep}


# -- the examples' models and the Accelerator's one-card surface -------------

EXAMPLES = dict(bert_batch=32, bert_seq=128, bert_steps=5, eval_batches=2,
                resnet_batch=32, resnet_hw=224, resnet_steps=3,
                profile=dict(wait=1, warmup=1, active=2))


class _BertRows:
    """``n`` seeded rows of token ids, a padding mask (a tail of 0..31
    padded tokens a row) and a label, as ``nlp_example``'s tokenized
    pairs."""

    def __init__(self, torch, n: int, vocab: int, seq: int, seed: int):
        rng = np.random.default_rng(seed)
        self.ids = torch.from_numpy(rng.integers(0, vocab, (n, seq)))
        pad = rng.integers(0, 32, (n,))
        self.mask = torch.from_numpy((np.arange(seq)[None, :] < seq - pad[:, None]).astype(
            np.int64))
        self.labels = torch.from_numpy(rng.integers(0, 2, (n,)))

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i],
                "labels": self.labels[i]}


def bert_run(torch, timeline: bool, project: Path, card: str, profile: bool,
             device: str = "cuda") -> dict:
    """nlp_example's loop on BertConfig.base() under bf16: a prepared
    loader, ``adamw``, trackers (JSONL) logged each step, the timeline on
    or off, optionally a profiled window; then the eval step with
    ``gather_for_metrics``."""
    from accelerate_tpu_torch import Accelerator, ProjectConfiguration
    from accelerate_tpu_torch.models import (
        BertConfig, BertForSequenceClassification, make_bert_loss_fn,
    )
    from accelerate_tpu_torch.utils.dataclasses import ProfileKwargs, TelemetryPlugin
    from accelerate_tpu_torch.utils.memory import get_device_memory_stats

    ex = EXAMPLES
    cfg = BertConfig.base()
    acc = Accelerator(mixed_precision="bf16", log_with="jsonl", device=device,
                      project_config=ProjectConfiguration(project_dir=str(project)),
                      telemetry_plugin=TelemetryPlugin(timeline=timeline))
    model = BertForSequenceClassification(cfg, device=device, seed=0)
    rows = ex["bert_batch"] * ex["bert_steps"]
    loader = acc.prepare(torch.utils.data.DataLoader(
        _BertRows(torch, rows, cfg.vocab_size, ex["bert_seq"], seed=1),
        batch_size=ex["bert_batch"]))
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_bert_loss_fn(model), max_grad_norm=1.0)
    acc.init_trackers("bert", config={"batch": ex["bert_batch"], "seq": ex["bert_seq"]})
    handler = ProfileKwargs(output_trace_dir=str(project / "profile"), **ex["profile"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    with (acc.profile(handler) if profile else contextlib.nullcontext()) as prof:
        for batch in loader:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = metrics["loss"].item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            acc.log({"loss": loss}, step=len(losses))
            if prof is not None:
                prof.step()
    peak = get_device_memory_stats(device)["peak_bytes_in_use"]
    acc.reset_step_cadence()
    eval_step = acc.prepare_eval_step(
        lambda params, b: torch.func.functional_call(
            model, params, (b["input_ids"],), {"attention_mask": b["attention_mask"]}))
    eval_loader = acc.prepare(torch.utils.data.DataLoader(
        _BertRows(torch, ex["bert_batch"] * ex["eval_batches"], cfg.vocab_size,
                  ex["bert_seq"], seed=2), batch_size=ex["bert_batch"]))
    preds, refs = [], []
    for batch in eval_loader:
        logits = eval_step(state.params, batch)
        p, r = acc.gather_for_metrics((logits.argmax(-1), batch["labels"]))
        preds.append(p)
        refs.append(r)
    preds, refs = torch.cat(preds), torch.cat(refs)
    acc.end_training()
    out = {"losses": losses, "step_ms": step_ms, "peak_bytes": peak,
           "eval_rows": int(preds.numel()), "eval_accuracy": (preds == refs).float().mean().item(),
           "summary": acc.timeline.summary() if timeline else None,
           "profile": prof.summary if prof is not None else None}
    del state, model, acc
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def examples_phase(torch, card: str, device: str = "cuda") -> dict:
    """The JAX examples' models through the one-card surface (module
    docstring, step 6d)."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import ResNet, ResNetConfig, make_resnet_loss_fn
    from accelerate_tpu_torch.utils.memory import get_device_memory_stats

    ex = EXAMPLES
    root = Path(tempfile.mkdtemp(prefix="examples_"))
    try:
        on = bert_run(torch, True, root / "on", card, profile=True, device=device)
        off = bert_run(torch, False, root / "off", card, profile=False, device=device)
        if not all(math.isfinite(x) for x in on["losses"]):
            raise AssertionError(f"bert losses not finite: {on['losses']}")
        if on["losses"] != off["losses"]:
            raise AssertionError(f"bert: the loss with the timeline on {on['losses']} is not "
                                 f"bitwise the loss with it off {off['losses']}")
        s = on["summary"]
        if s["step_dispatch"]["count"] != ex["bert_steps"]:
            raise AssertionError(f"bert: step_dispatch counted {s['step_dispatch']['count']} "
                                 f"times in {ex['bert_steps']} steps")
        if on["eval_rows"] != ex["bert_batch"] * ex["eval_batches"]:
            raise AssertionError(f"bert eval gathered {on['eval_rows']} rows")
        metrics = [json.loads(l) for l in (root / "on" / "bert" / "metrics.jsonl")
                   .read_text().splitlines()]
        if [m["loss"] for m in metrics] != on["losses"]:
            raise AssertionError("bert: the JSONL tracker's losses are not the steps'")
        p = on["profile"]
        want = list(range(ex["profile"]["wait"] + ex["profile"]["warmup"],
                          ex["profile"]["wait"] + ex["profile"]["warmup"]
                          + ex["profile"]["active"]))
        trace = root / "on" / "profile" / "trace.json"
        if p["traced_steps"] != want or not trace.exists():
            raise AssertionError(f"bert profile: traced {p['traced_steps']}, trace "
                                 f"{trace.exists()}")
        kernels = sum(1 for e in json.loads(trace.read_text())["traceEvents"]
                      if e.get("cat") == "kernel")
        bert = {k: on[k] for k in ("losses", "step_ms", "peak_bytes", "eval_rows",
                                   "eval_accuracy", "summary")}
        bert.update(profiled_steps=p["traced_steps"], trace_kernel_events=kernels,
                    trace_bytes=trace.stat().st_size)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("examples_bert", json.dumps(bert))

    # cv_example: ResNet-50's stages at 224^2, batch-norm statistics out as the
    # step's aux and folded back
    cfg = ResNetConfig.resnet50()
    model = ResNet(cfg, device=device, seed=0)
    acc = Accelerator(mixed_precision="bf16", device=device)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_resnet_loss_fn(model), has_aux=True)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal(
        (ex["resnet_batch"], ex["resnet_hw"], ex["resnet_hw"], 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (ex["resnet_batch"],))).to(device)
    mean0 = model.stem_bn.mean.clone()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(ex["resnet_steps"]):
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": images, "label": labels})
        model.load_batch_stats(metrics["aux"])
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = get_device_memory_stats(device)["peak_bytes_in_use"]
    n_stats = len(metrics["aux"])
    if not (all(math.isfinite(x) for x in losses)
            and all(torch.isfinite(s[k]).all() for s in metrics["aux"].values()
                    for k in ("mean", "var"))
            and not torch.equal(model.stem_bn.mean, mean0)):
        raise AssertionError(f"resnet: losses or batch statistics not finite, or not folded: "
                             f"{losses}")
    resnet = {"losses": losses, "step_ms": step_ms, "peak_bytes": peak,
              "batch_norms": n_stats, "batch": ex["resnet_batch"], "hw": ex["resnet_hw"]}
    log("examples_resnet", json.dumps(resnet))
    log(f"examples on {card}: bert-base {np.median(bert['step_ms'][1:]):.1f} ms/step at "
        f"{ex['bert_batch']}x{ex['bert_seq']}, peak {bert['peak_bytes'] / 2**30:.2f} GiB; "
        f"resnet50 {np.median(step_ms[1:]):.1f} ms/step at {ex['resnet_batch']}x"
        f"{ex['resnet_hw']}^2, peak {peak / 2**30:.2f} GiB")
    del state, model, acc, images
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"bert": bert, "resnet": resnet}


# data and context parallelism (step 6e): the world of one's steps at the
# 600m model, and the virtual cp ring at its attention width
PARALLEL = dict(batch=4, seq=2048, steps=4, cp=4, ring_t=8192, segments=(3000, 3500, 1692),
                timed=5)


def parallel_steps(torch, acc, loss_fn, params, optimizer: str):
    """``PARALLEL["steps"]`` steps through ``acc``'s prepared loader over
    seeded 600m token rows: the state, each step's loss and each step's
    ms (host clock, ended by a device sync)."""
    rows = torch.from_numpy(np.random.default_rng(17).integers(
        0, MODEL["vocab_size"], (PARALLEL["batch"] * PARALLEL["steps"], PARALLEL["seq"])))
    loader = acc.prepare(torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(rows), batch_size=PARALLEL["batch"],
        collate_fn=lambda b: {"input_ids": torch.stack([r[0] for r in b]),
                              "labels": torch.stack([r[0] for r in b])}))
    state = acc.create_train_state(params, optimizer)
    step = acc.prepare_train_step(loss_fn)
    losses, step_ms = [], []
    for batch in loader:
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync(torch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].detach())
    return state, losses, step_ms


def world_of_one(torch, card: str) -> dict:
    """(a): the 600m steps under a parallelism config in an NCCL world of
    one, bitwise the single-process steps; the façade's identities."""
    import tempfile

    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.ops import operations as ops
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import (
        FullyShardedDataParallelPlugin, GradSyncKwargs, ShardingStrategy,
    )

    with tempfile.TemporaryDirectory() as rendezvous:
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store",
                                world_size=1, rank=0)
        try:
            cfg, model, params, single, loss_fn = train_setup(torch, seed=3)
            first = {n: p.clone() for n, p in params.items()}
            s_state, s_losses, single_ms = parallel_steps(torch, single, loss_fn, params,
                                                          TRAIN["optimizer"])
            acc = Accelerator(mixed_precision="bf16", parallelism_config=ParallelismConfig(),
                              fsdp_plugin=FullyShardedDataParallelPlugin(
                                  sharding_strategy=ShardingStrategy.FULL_SHARD),
                              kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
            reset_counts()
            p_state, p_losses, parallel_ms = parallel_steps(torch, acc, loss_fn, first,
                                                            TRAIN["optimizer"])
            launches = launch_counts()
            same = {
                "params": all(torch.equal(p_state.params[n], s_state.params[n])
                              for n in s_state.params),
                "momentum": all(torch.equal(a, b) for a, b in zip(p_state.opt_state.mu,
                                                                   s_state.opt_state.mu)),
                "count": p_state.opt_state.count == s_state.opt_state.count,
                "loss": all(torch.equal(a, b) for a, b in zip(p_losses, s_losses)),
            }
            x = torch.randn(8, 4, device="cuda")
            identities = {
                "gather": torch.equal(acc.gather(x), x),
                "reduce": torch.equal(acc.reduce(x), x),
                "broadcast": torch.equal(ops.broadcast(x), x),
                "pad_across_processes": torch.equal(acc.pad_across_processes(x), x),
                "gather_for_metrics": torch.equal(acc.gather_for_metrics(x), x),
            }
            rep = {"world": dist.get_world_size(), "backend": dist.get_backend(),
                   "mesh": {n: int(s) for n, s in zip(acc.mesh.mesh_dim_names,
                                                       acc.mesh.mesh.shape)},
                   "bitwise": same, "identities": identities,
                   "losses": [float(v) for v in p_losses],
                   "distributed_type": str(acc.distributed_type),
                   # step 1 of the first run warms the card up for both
                   "single_step_ms": single_ms, "parallel_step_ms": parallel_ms,
                   "median_ms_after_first": [float(np.median(single_ms[1:])),
                                             float(np.median(parallel_ms[1:]))],
                   "flash_launches": {k: launches[k] for k in FLASH_REPLACES}, "card": card}
            log("parallel (a) world of one:", json.dumps(rep))
            if not (all(same.values()) and all(identities.values())
                    and all(math.isfinite(v) for v in rep["losses"])):
                raise AssertionError(f"world of one off the single-process step: {rep}")
        finally:
            acc = model = params = first = s_state = p_state = single = None
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rep


def ring_case(torch, tcp, q, k, v, g, seg, plain: bool) -> list:
    """One pass of the virtual ring: out, dq, dk, dv (in the ring's zigzag
    layout) of ``sum(out * g)``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = tcp.virtual_ring_attention(q, k, v, PARALLEL["cp"], causal=True, segment_ids=seg,
                                     plain=plain)
    out.backward(g)
    return [out.detach(), q.grad, k.grad, v.grad]


def virtual_ring(torch, fa, card: str) -> dict:
    """(b): the cp 4 ring at the 600m attention width, the kernels against
    the plain ring and the unsharded kernels; times, launches, peak
    memory."""
    from accelerate_tpu_torch.parallel import context_parallel as tcp

    cp, t = PARALLEL["cp"], PARALLEL["ring_t"]
    q, k, v, g, _, _ = flash_inputs(torch, b=1, t=t, seed=23)
    cuts = torch.tensor(np.cumsum(PARALLEL["segments"])[:-1], device="cuda")
    packed = (torch.arange(t, device="cuda")[None, :, None] >= cuts[None, None]).sum(-1).int()
    zig = [tcp.zigzag_shard(x, cp) for x in (q, k, v, g)]
    out = {"card": card, "shape": {"b": 1, "t": t, "cp": cp, "h": FLASH_HEADS["h"],
                                   "hkv": FLASH_HEADS["hkv"], "d": FLASH_HEADS["d"]}}
    for label, seg in (("causal", None), ("packed", packed)):
        seg_z = tcp.zigzag_shard(seg, cp) if seg is not None else None
        reset_counts()
        got = ring_case(torch, tcp, *zig, seg_z, plain=False)
        sync(torch)
        counts = {n: getattr(fa, n).launches for n in FLASH_REPLACES}
        if any(c != cp * cp for c in counts.values()):
            raise AssertionError(f"ring {label}: launches {counts}, want {cp * cp} each")
        plain = [tcp.zigzag_unshard(x, cp) for x in ring_case(torch, tcp, *zig, seg_z, plain=True)]
        got = [tcp.zigzag_unshard(x, cp) for x in got]
        # one unsharded call of #1-#3, causal by index
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        whole = fa.flash_attention(qq, kk, vv, causal=True,
                                   **({"segment_ids": seg} if seg is not None else {}))
        whole.backward(g)
        ref = [whole.detach(), qq.grad, kk.grad, vv.grad]
        rep = {"launches": counts}
        for name, a, b, r in zip(("out", "dq", "dk", "dv"), got, plain, ref):
            rep[f"{name}_vs_plain"] = held_to_plain(torch, f"ring {label} {name}", a, b,
                                                    slack=half_ulp_bf16(torch, b))
            # each block's out is rounded to bf16 before the f32 combine:
            # one bf16 step of |ref| beside the kernels' own tolerance
            err = (a.float() - r.float()).abs()
            limit = 2 * half_ulp_bf16(torch, r) + KERNEL_TOL * r.float().abs().amax()
            rep[f"{name}_vs_unsharded"] = {
                "max_abs_err": err.max().item(),
                "err_over_limit": (err / limit.clamp(min=1e-30)).max().item()}
            if not (rep[f"{name}_vs_unsharded"]["err_over_limit"] <= 1.0
                    and bool(torch.isfinite(a).all())):
                raise AssertionError(f"ring {label} {name} off the unsharded kernels: {rep}")
        out[label] = rep
        del got, plain, ref, whole

    def ring_pass(i):
        ring_case(torch, tcp, *zig, None, plain=False)

    def whole_pass(i):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        fa.flash_attention(qq, kk, vv, causal=True).backward(g)

    sync(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["ring_ms"] = time_ms(torch, ring_pass, iters=PARALLEL["timed"], warmup=1)
    out["ring_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    torch.cuda.reset_peak_memory_stats()
    out["unsharded_ms"] = time_ms(torch, whole_pass, iters=PARALLEL["timed"], warmup=1)
    out["unsharded_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["ring_over_unsharded"] = out["ring_ms"] / out["unsharded_ms"]
    # where a pass's time goes: the kernels, the combine's eager ops, the host
    out["ring_profile"] = profiled_step(torch, lambda: ring_pass(0), top=10)
    out["unsharded_profile"] = profiled_step(torch, lambda: whole_pass(0), top=4)
    log("parallel (b) virtual ring:", json.dumps(out))
    return out


def _layout(**sizes) -> tuple:
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER

    return MESH_AXIS_ORDER, tuple(sizes.get(a, 1) for a in MESH_AXIS_ORDER)


def ulysses_pass(torch, attn, mesh, q, k, v, g, seg) -> list:
    """One fwd + bwd of Ulysses over ``mesh``'s sp ranks, each rank its
    contiguous slice of ``q`` / ``k`` / ``v`` / ``seg``: out, dq, dk, dv
    whole."""
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    sp = PARALLEL["cp"]
    qs, ks, vs = ([c.contiguous().requires_grad_() for c in x.detach().chunk(sp, dim=1)]
                  for x in (q, k, v))
    segs = seg.chunk(sp, dim=1) if seg is not None else [None] * sp
    outs = mesh.run(lambda r: attn(qs[r], ks[r], vs[r], causal=True,
                                   segment_ids=None if segs[r] is None
                                   else segs[r].contiguous()),
                    ParallelismConfig(sp_size=sp))
    torch.autograd.backward(outs, [c.contiguous() for c in g.chunk(sp, dim=1)])
    return [torch.cat(outs, dim=1).detach()] + [torch.cat([x.grad for x in xs], dim=1)
                                                for xs in (qs, ks, vs)]


def virtual_ulysses(torch, fa, card: str, ring: dict, device: str = "cuda") -> dict:
    """(c): Ulysses over a virtual sp 4 world at (b)'s shapes, the kernels
    against the plain versions and the unsharded call; times, launches,
    peak memory."""
    from accelerate_tpu_torch.parallel.sequence_parallel import make_ulysses_attention
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh

    sp, t = PARALLEL["cp"], PARALLEL["ring_t"]
    mesh = VirtualMesh(*_layout(sp=sp))
    attn = make_ulysses_attention(mesh)
    attn_plain = make_ulysses_attention(mesh, inner_attn=fa.flash_attention_plain)
    q, k, v, g, _, _ = flash_inputs(torch, b=1, t=t, seed=23, device=device)
    cuts = torch.tensor(np.cumsum(PARALLEL["segments"])[:-1], device=device)
    packed = (torch.arange(t, device=device)[None, :, None] >= cuts[None, None]).sum(-1).int()
    out = {"card": card, "shape": {"b": 1, "t": t, "sp": sp, "h": FLASH_HEADS["h"],
                                   "hkv": FLASH_HEADS["hkv"], "d": FLASH_HEADS["d"],
                                   "rank_heads": [FLASH_HEADS["h"] // sp,
                                                  FLASH_HEADS["hkv"] // sp]}}
    for label, seg in (("causal", None), ("packed", packed)):
        reset_counts()
        got = ulysses_pass(torch, attn, mesh, q, k, v, g, seg)
        sync(torch)
        counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
        if any(c != sp for c in counts.values()):
            raise AssertionError(f"ulysses {label}: launches {counts}, want {sp} each")
        plain = ulysses_pass(torch, attn_plain, mesh, q, k, v, g, seg)
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        whole = fa.flash_attention(qq, kk, vv, causal=True,
                                   **({"segment_ids": seg} if seg is not None else {}))
        whole.backward(g)
        ref = [whole.detach(), qq.grad, kk.grad, vv.grad]
        rep = {"launches": counts, "all_to_all_calls": mesh.calls.get("all_to_all", 0)}
        for name, a, b, r in zip(("out", "dq", "dk", "dv"), got, plain, ref):
            rep[f"{name}_vs_plain"] = held_to_plain(torch, f"ulysses {label} {name}", a, b,
                                                    slack=half_ulp_bf16(torch, b))
            err = (a.float() - r.float()).abs()
            limit = 2 * half_ulp_bf16(torch, r) + KERNEL_TOL * r.float().abs().amax()
            rep[f"{name}_vs_unsharded"] = {
                "max_abs_err": err.max().item(), "bitwise": bool(torch.equal(a, r)),
                "err_over_limit": (err / limit.clamp(min=1e-30)).max().item()}
            if not (rep[f"{name}_vs_unsharded"]["err_over_limit"] <= 1.0
                    and bool(torch.isfinite(a).all())):
                raise AssertionError(f"ulysses {label} {name} off the unsharded call: {rep}")
        out[label] = rep
        del got, plain, ref, whole

    def uly(i):
        ulysses_pass(torch, attn, mesh, q, k, v, g, None)

    def whole_pass(i):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        fa.flash_attention(qq, kk, vv, causal=True).backward(g)

    sync(torch)
    cuda = device == "cuda"
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out["ulysses_ms"] = time_ms(torch, uly, iters=PARALLEL["timed"], warmup=1)
    out["ulysses_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out["unsharded_ms"] = time_ms(torch, whole_pass, iters=PARALLEL["timed"], warmup=1)
    out["unsharded_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else 0
    out["ring_ms"] = ring["ring_ms"]
    out["ulysses_over_unsharded"] = out["ulysses_ms"] / out["unsharded_ms"]
    out["ring_over_ulysses"] = ring["ring_ms"] / out["ulysses_ms"]
    out["ulysses_profile"] = profiled_step(torch, lambda: uly(0), top=8)
    log("parallel (c) virtual ulysses:", json.dumps(out))
    return out


TP = dict(tp=4, batch=4, seq=2048, timed=3, modes=("off", "ring"))


def virtual_tp(torch, fa, card: str, device: str = "cuda") -> dict:
    """(d): the 600m model's fwd + bwd over a virtual tp 4 world, modes off
    and ring, against the unsharded fwd + bwd on the same weights and
    batch; launches, times, one profiled step a mode."""
    from accelerate_tpu_torch.ops.collective_matmul import collective_matmul
    from accelerate_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, make_sharding_plan, tp_shard, tp_split_dim,
    )
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.models.llama import make_llama_loss_fn

    tp = TP["tp"]
    cfg, model, params, _, loss_fn = train_setup(torch, seed=5, device=device)
    names = list(params)
    batch = token_batch(torch, cfg.vocab_size, TP["batch"], device)
    layout = _layout(tp=tp)
    plan = make_sharding_plan(params, layout, ParallelismConfig(tp_size=tp), None,
                              TRANSFORMER_TP_RULES)
    dims = {n: tp_split_dim(plan[n]) for n in names}
    shards = [{n: tp_shard(params[n], dims[n], tp, r).detach().requires_grad_()
               for n in names} for r in range(tp)]
    replicas = [module_replica(model) for _ in range(tp)]
    rank_loss = [make_llama_loss_fn(m, fused_vocab_chunks=TRAIN["ce_chunks"]) for m in replicas]
    mesh = VirtualMesh(*layout)

    def unsharded():
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = loss_fn(leaves, batch).float()
        return loss, list(torch.autograd.grad(loss, list(leaves.values())))

    def sharded(mode):
        with collective_matmul(mode):
            losses = mesh.run(lambda r: rank_loss[r](shards[r], batch).float(),
                              ParallelismConfig(tp_size=tp))
        leaves = [s[n] for s in shards for n in names]
        flat = torch.autograd.grad(losses, leaves)
        by_rank = [flat[r * len(names):(r + 1) * len(names)] for r in range(tp)]
        grads = [torch.cat([by_rank[r][i] for r in range(tp)], dim=dims[n])
                 if dims[n] is not None else by_rank[0][i] for i, n in enumerate(names)]
        return losses[0], grads, losses

    ref = unsharded()
    out = {"card": card, "shape": {"tp": tp, "batch": TP["batch"], "seq": TP["seq"],
                                   "rank_heads": [cfg.num_attention_heads // tp,
                                                  cfg.num_key_value_heads // tp],
                                   "rank_intermediate": cfg.intermediate_size // tp,
                                   "rank_vocab": cfg.vocab_size // tp}}
    got = {}
    for mode in TP["modes"]:
        reset_counts()
        got[mode] = sharded(mode)
        sync(torch)
        counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
        want = tp * cfg.num_hidden_layers
        if any(c != want for c in counts.values()):
            raise AssertionError(f"tp {mode}: launches {counts}, want {want} each")
        rep = grads_against(torch, f"tp {mode}", names, got[mode][:2], ref)
        rep["launches"] = counts
        rep["collectives"] = dict(mesh.calls)
        rep["ranks_loss_spread"] = max(abs(x.item() - got[mode][2][0].item())
                                       for x in got[mode][2])
        if mesh.calls.get("pmax") != 1:
            raise AssertionError(f"tp {mode}: the vocab-parallel loss did not run: {mesh.calls}")
        out[mode] = rep
    out["ring_vs_off"] = grads_against(torch, "tp ring vs off", names, got["ring"][:2],
                                       got["off"][:2])
    del got
    ms = {"unsharded": [], **{m: [] for m in TP["modes"]}}
    for _ in range(TP["timed"]):
        for label in ("unsharded",) + TP["modes"]:
            sync(torch)
            t0 = time.perf_counter()
            res = unsharded() if label == "unsharded" else sharded(label)
            sync(torch)
            ms[label].append((time.perf_counter() - t0) * 1e3)
            del res
    out["step_ms"] = ms
    out["median_ms"] = {k: float(np.median(v[1:] if len(v) > 1 else v)) for k, v in ms.items()}
    for mode in TP["modes"]:
        out[f"{mode}_over_unsharded"] = out["median_ms"][mode] / out["median_ms"]["unsharded"]
        out[f"{mode}_profile"] = profiled_step(torch, lambda mode=mode: sharded(mode), top=10)
    out["unsharded_profile"] = profiled_step(torch, unsharded, top=6)
    sync(torch)
    if device == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("parallel (d) virtual tp:", json.dumps(out))
    del shards, replicas, params, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# (e) pipeline parallelism: the 600m model at full width and depth as a
# GPipe pipeline over a virtual pp 4 world, 4 layers a stage
PIPE = dict(pp=4, batch=8, seq=2048, microbatches=8, timed=3)


def grads_against(torch, label, names, got, ref, rtol=None) -> dict:
    """Loss, grad norm and every leaf of ``got`` = (loss, grads) against
    ``ref`` under the batch-2 rule (loss ``LOSS_RTOL``, norm ``GNORM_RTOL``,
    each leaf ``LEAF_RTOL``); raises when off it."""
    from accelerate_tpu_torch.accelerator import global_norm

    (loss, grads), (rl, rg) = got, ref
    gn, rgn = global_norm(list(grads)).item(), global_norm(list(rg)).item()
    leaf = {n: ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
            for n, a, b in zip(names, grads, rg)}
    worst = max(leaf, key=leaf.get)
    rep = {"loss": loss.item(), "ref_loss": rl.item(),
           "loss_rel": abs(loss.item() - rl.item()) / abs(rl.item()),
           "grad_norm": gn, "ref_grad_norm": rgn, "grad_norm_rel": abs(gn - rgn) / rgn,
           "worst_leaf": worst, "worst_leaf_rel_err": leaf[worst],
           "median_leaf_rel_err": float(np.median(list(leaf.values())))}
    if (rep["loss_rel"] > LOSS_RTOL or rep["grad_norm_rel"] > GNORM_RTOL
            or rep["worst_leaf_rel_err"] > LEAF_RTOL or not math.isfinite(rep["loss"])):
        raise AssertionError(f"{label}: off the reference step: {rep}")
    return rep


def virtual_pp(torch, fa, card: str, device: str = "cuda") -> dict:
    """(e): the 600m model's fwd + bwd at 8 x 2048 through
    ``prepare_pipeline`` over a virtual pp 4 world (8 microbatches of one
    row), against the unsharded fwd + bwd on the same weights and batch:
    launches, every launch held to its plain version, logits, loss, grad
    norm and every leaf, ms and peak memory."""
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss
    from accelerate_tpu_torch.parallel.pipeline_parallel import prepare_pipeline
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    pp, mbs = PIPE["pp"], PIPE["microbatches"]
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    names = [n for n, _ in model.named_parameters()]
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PIPE["batch"], PIPE["seq"]))).to(device)
    mesh = VirtualMesh(*_layout(pp=pp))
    pcfg = ParallelismConfig(pp_size=pp)
    pipes = mesh.run(lambda r: prepare_pipeline(model, num_microbatches=mbs), pcfg)
    per = cfg.num_hidden_layers // pp

    def unsharded():
        leaves = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
        logits = torch.func.functional_call(model, leaves, (ids,))
        loss = causal_lm_loss(logits, ids)
        return loss, torch.autograd.grad(loss, list(leaves.values())), logits.detach()

    def piped():
        def rank(r):
            pm = pipes[r]
            st = {k: v.detach().requires_grad_() for k, v in pm.stacked.items()}
            rest = {k: v.detach().requires_grad_() for k, v in pm.rest.items()}
            logits = pm(ids, st, rest)
            return causal_lm_loss(logits, ids), logits.detach(), st, rest

        outs = mesh.run(rank, pcfg)
        leaves = [t for o in outs for t in list(o[2].values()) + list(o[3].values())]
        flat = iter(torch.autograd.grad([o[0] for o in outs], leaves))
        by_rank = [({k: next(flat) for k in o[2]}, {k: next(flat) for k in o[3]}) for o in outs]
        grads = {}
        for r, (st, _) in enumerate(by_rank):
            for k, g in st.items():
                for i in range(per):
                    grads[f"model.layers.{r * per + i}.{k}"] = g[i]
        grads.update(by_rank[0][1])
        spread = max((a - b).abs().max().item() for _, rest in by_rank[1:]
                     for a, b in zip(rest.values(), by_rank[0][1].values()))
        return (outs[0][0].detach(), [grads[n] for n in names], outs[0][1],
                [o[0].item() for o in outs], spread)

    ref = unsharded()
    reset_counts()
    got = piped()
    sync(torch)
    counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
    want = cfg.num_hidden_layers * mbs
    if any(c != want for c in counts.values()):
        raise AssertionError(f"pp: launches {counts}, want {want} each")
    rep = {"card": card, "shape": {"pp": pp, "batch": PIPE["batch"], "seq": PIPE["seq"],
                                   "microbatches": mbs, "layers_per_stage": per},
           "launches": counts, "collectives": dict(mesh.calls),
           "vs_unsharded": grads_against(torch, "pp", names, got[:2], ref[:2])}
    err = (got[2] - ref[2]).abs().max().item()
    ref_max = ref[2].abs().max().item()
    rep["logits"] = {"max_abs_err": err, "ref_max": ref_max, "err_over_ref_max": err / ref_max}
    if not err <= KERNEL_TOL * ref_max:
        raise AssertionError(f"pp: logits off the unsharded model's: {rep['logits']}")
    rep["stage_losses_spread"] = max(got[3]) - min(got[3])
    rep["rest_grads_spread"] = got[4]
    del got
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        piped()
    rep["in_path"] = worst_of(readings, {n: want for n in FLASH_REPLACES})
    ms, peak = {"unsharded": [], "pipelined": []}, {}
    for _ in range(PIPE["timed"]):
        for label, fn in (("unsharded", unsharded), ("pipelined", piped)):
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = fn()
            sync(torch)
            ms[label].append((time.perf_counter() - t0) * 1e3)
            peak[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
            del res
    rep["step_ms"] = ms
    rep["median_ms"] = {k: float(np.median(v[1:] if len(v) > 1 else v)) for k, v in ms.items()}
    rep["pipelined_over_unsharded"] = rep["median_ms"]["pipelined"] / rep["median_ms"]["unsharded"]
    rep["peak_gib_above_weights"] = peak
    rep["bubble_share"] = (pp - 1) / (mbs + pp - 1)
    rep["pipelined_profile"] = profiled_step(torch, piped, top=8)
    log("parallel (e) virtual pp:", json.dumps(rep))
    del pipes, model, ref
    torch.cuda.empty_cache()
    return rep


# (g) multi-node data parallelism: the 600m model's gradients on a virtual
# dcn 2 x dp_shard 2 world, each rank's row of a 4 x 2048 batch, reduced
# hierarchically (dense, then PowerSGD across dcn) and by the flat PowerSGD
# codec; then the Accelerator's PowerSGD step in an NCCL world of one
DCN = dict(dcn=2, ici=2, rank=4, syncs=3, steps=4)


def leaf_rel_errs(torch, got: dict, ref: dict) -> dict:
    """``||got - ref|| / ||ref||`` of each leaf."""
    return {n: ((got[n] - ref[n]).norm() / ref[n].norm().clamp(min=1e-30)).item() for n in ref}


def rel_summary(errs: dict) -> dict:
    worst = max(errs, key=errs.get)
    return {"worst_leaf": worst, "worst_rel_err": errs[worst],
            "median_rel_err": float(np.median(list(errs.values())))}


def virtual_dcn(torch, fa, card: str, device: str = "cuda") -> dict:
    """(g): each rank's fwd + bwd (#1-#3 held to their plain versions in the
    path), then through ``VirtualMesh.run`` the dense hierarchical sync
    against the flat mean, three syncs with the DCN codec at rank 4, three
    of the flat codec over all four ranks; per-leaf errors, residual norms,
    ms, and the DCN bytes the recorder saw against ``dcn_comm_accounting``
    (equal, exactly)."""
    from accelerate_tpu_torch.parallel.hierarchical import (
        dcn_comm_accounting, hierarchical_sync, init_dcn_powersgd_state, measure_dcn_bytes,
        record_collectives,
    )
    from accelerate_tpu_torch.parallel.powersgd import (
        compress_decompress, init_powersgd_state, residual_norms,
    )
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh

    world, ici = DCN["dcn"] * DCN["ici"], DCN["ici"]
    cfg, model, params, _, loss_fn = train_setup(torch, seed=6, device=device)
    names = list(params)
    batch = token_batch(torch, cfg.vocab_size, world, device)
    readings = {n: [] for n in FLASH_REPLACES}
    reset_counts()
    grads = []
    sync(torch)
    t0 = time.perf_counter()
    with checked_flash_kernels(torch, fa, readings):
        for r in range(world):
            leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
            loss = loss_fn(leaves, {k: v[r:r + 1] for k, v in batch.items()}).float()
            grads.append({n: g.float() for n, g in
                          zip(names, torch.autograd.grad(loss, list(leaves.values())))})
            del leaves, loss
    sync(torch)
    out = {"card": card, "world": {"dcn": DCN["dcn"], "dp_shard": ici}, "batch": [world, TRAIN["seq"]],
           "rank_passes_ms_checked": (time.perf_counter() - t0) * 1e3,
           "launches": {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES},
           "in_path": worst_of(readings, {n: world * cfg.num_hidden_layers
                                          for n in FLASH_REPLACES})}
    mean = {n: sum(g[n] for g in grads) / world for n in names}
    mesh = VirtualMesh(("dcn", "dp_shard"), (DCN["dcn"], ici))

    def timed(fn):
        sync(torch)
        t = time.perf_counter()
        res = fn()
        sync(torch)
        return res, (time.perf_counter() - t) * 1e3

    predicted = dcn_comm_accounting(params, ici_size=ici, dcn_size=DCN["dcn"])

    def dense_sync():
        return mesh.run(lambda r: hierarchical_sync(grads[r], ("dp_shard",), "dcn",
                                                    mesh=mesh)[0])

    # the first sync allocates the world's buffers; the second is warm
    first_ms = timed(lambda: dense_sync() and None)[1]
    with record_collectives() as rec:
        dense, ms = timed(dense_sync)
    measured = measure_dcn_bytes(rec, dcn_size=DCN["dcn"])
    same_on_ranks = all(torch.equal(dense[r][n], dense[0][n]) for r in range(1, world)
                        for n in names)
    out["dense"] = {"ms": ms, "first_ms": first_ms,
                    **rel_summary(leaf_rel_errs(torch, dense[0], mean)),
                    "same_on_every_rank": same_on_ranks,
                    "dcn_bytes_measured": measured["dcn_bytes"],
                    "dcn_bytes_per_rank": measured["per_rank"],
                    "dcn_bytes_predicted": predicted["dcn_bytes"],
                    "dcn_bytes_flat": predicted["dcn_bytes_flat"],
                    "dcn_s_per_step_at_50_gb_s": predicted["dcn_s_per_step"],
                    "flat_dcn_s_per_step_at_50_gb_s": predicted["dcn_bytes_flat"] / 50e9}
    del dense
    out["dense"]["profile"] = profiled_step(torch, dense_sync, top=6)

    def codec_syncs(run_one, state, pred=None):
        """``DCN["syncs"]`` syncs of the same gradients, each rank's codec
        state carried: per sync its error against the mean, and the error of
        the syncs' running average (error feedback drives it down)."""
        rows, total = [], None
        for k in range(1, DCN["syncs"] + 1):
            with record_collectives() as rec:
                res, ms = timed(lambda: mesh.run(lambda r: run_one(r, state[r])))
            state = [(o[1], o[2]) for o in res]
            total = dict(res[0][0]) if total is None else {n: total[n] + res[0][0][n]
                                                            for n in names}
            norms = residual_norms(state[0][1])
            running = rel_summary(leaf_rel_errs(torch, {n: total[n] / k for n in names}, mean))
            row = {"ms": ms, **rel_summary(leaf_rel_errs(torch, res[0][0], mean)),
                   "running_mean_worst_rel_err": running["worst_rel_err"],
                   "running_mean_median_rel_err": running["median_rel_err"],
                   "residual_norm_total": math.sqrt(sum(v * v for v in norms.values())),
                   "residual_norm_worst_leaf": max(norms, key=norms.get),
                   "residual_norm_worst": max(norms.values())}
            if pred is not None:
                row["dcn_bytes_measured"] = measure_dcn_bytes(rec, dcn_size=DCN["dcn"])[
                    "dcn_bytes"]
                row["dcn_bytes_predicted"] = pred["dcn_bytes"]
            rows.append(row)
            del res
        return rows

    qs, errs = init_dcn_powersgd_state(params, DCN["rank"], ici, device=device)
    pred_c = dcn_comm_accounting(params, ici_size=ici, dcn_size=DCN["dcn"],
                                 compression="powersgd", rank=DCN["rank"])
    out["dcn_powersgd"] = codec_syncs(
        lambda r, st: hierarchical_sync(grads[r], ("dp_shard",), "dcn", qs=st[0], errs=st[1],
                                        rank=DCN["rank"], mesh=mesh),
        [(qs, {n: e.clone() if e is not None else None for n, e in errs.items()})
         for _ in range(world)], pred_c)
    out["dcn_powersgd_bytes"] = {k: pred_c[k] for k in ("dcn_bytes", "dcn_bytes_flat", "ratio",
                                                         "eligible_leaves", "dense_leaves",
                                                         "dcn_s_per_step")}
    del qs, errs
    torch.cuda.empty_cache()
    fq, fe = init_powersgd_state(params, DCN["rank"], device=device)
    out["flat_powersgd"] = codec_syncs(
        lambda r, st: compress_decompress(grads[r], st[0], st[1], ("dcn", "dp_shard"),
                                          DCN["rank"], mesh),
        [(fq, {n: e.clone() if e is not None else None for n, e in fe.items()})
         for _ in range(world)])
    sync(torch)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("parallel (g) virtual dcn:", json.dumps(out))
    failures = []
    for n, c in out["launches"].items():
        if c != world * cfg.num_hidden_layers:
            failures.append(f"{n} launched {c} times, not {world * cfg.num_hidden_layers}")
    if not same_on_ranks or out["dense"]["worst_rel_err"] > 1e-5:
        failures.append(f"the dense sync is off the flat mean: {out['dense']}")
    if not (out["dense"]["dcn_bytes_measured"] == out["dense"]["dcn_bytes_predicted"]
            and set(out["dense"]["dcn_bytes_per_rank"].values()) == {predicted["dcn_bytes"]}):
        failures.append(f"dense DCN bytes measured {measured} against {predicted}")
    for row in out["dcn_powersgd"]:
        if row["dcn_bytes_measured"] != row["dcn_bytes_predicted"]:
            failures.append(f"codec DCN bytes {row}")
    for label in ("dcn_powersgd", "flat_powersgd"):
        if not all(math.isfinite(r["worst_rel_err"]) and math.isfinite(r["residual_norm_total"])
                   for r in out[label]):
            failures.append(f"{label} not finite: {out[label]}")
    del grads, mean, fq, fe, params, model
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("parallel (g): " + "; ".join(failures))
    return out


def powersgd_world_of_one(torch, card: str, device: str = "cuda") -> dict:
    """(g'): the Accelerator's PowerSGD step (rank 4, NO_SHARD) in an NCCL
    world of one, 4 steps on one 4 x 2048 batch: the codec compresses a
    world of one too (the JAX package's step engages it on a one-device
    mesh); losses finite and falling, step ms beside the flat step's on a
    copy of the same weights and batch."""
    import tempfile

    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.parallel.powersgd import residual_norms
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import (
        FullyShardedDataParallelPlugin, GradSyncKwargs,
    )

    with tempfile.TemporaryDirectory() as rendezvous:
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store",
                                world_size=1, rank=0)
        try:
            cfg, model, params, _, loss_fn = train_setup(torch, seed=3, device=device)
            first = {n: p.clone() for n, p in params.items()}
            batch = token_batch(torch, cfg.vocab_size, PARALLEL["batch"], device)

            def run(weights, handlers):
                acc = Accelerator(mixed_precision="bf16", parallelism_config=ParallelismConfig(),
                                  fsdp_plugin=FullyShardedDataParallelPlugin(
                                      sharding_strategy="NO_SHARD"),
                                  kwargs_handlers=handlers)
                state = acc.create_train_state(weights, TRAIN["optimizer"])
                step = acc.prepare_train_step(loss_fn)
                losses, step_ms = [], []
                for _ in range(DCN["steps"]):
                    sync(torch)
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    sync(torch)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss"].item())
                return acc, state, losses, step_ms

            _, _, flat_losses, flat_ms = run(first, [])
            reset_counts()
            acc, state, losses, step_ms = run(params, [GradSyncKwargs(compression="powersgd",
                                                                      rank=DCN["rank"])])
            launches = {n: fa_launches(n) for n in FLASH_REPLACES}
            norms = residual_norms(state.comm_state[1])
            rep = {"card": card, "rank": DCN["rank"], "losses": losses,
                   "flat_losses": flat_losses, "step_ms": step_ms, "flat_step_ms": flat_ms,
                   "median_ms_after_first": float(np.median(step_ms[1:])),
                   "flat_median_ms_after_first": float(np.median(flat_ms[1:])),
                   "dcn_sync": acc.dcn_sync,
                   "residual_norm_total": math.sqrt(sum(v * v for v in norms.values())),
                   "codec_leaves": sum(q is not None for q in state.comm_state[0].values()),
                   "launches": launches}
            rep["over_flat"] = rep["median_ms_after_first"] / rep["flat_median_ms_after_first"]
            log("parallel (g') PowerSGD step, world of one:", json.dumps(rep))
            want = DCN["steps"] * cfg.num_hidden_layers
            if not (all(math.isfinite(v) for v in rep["losses"])
                    and rep["losses"][-1] < rep["losses"][0]
                    and all(c == want for c in launches.values())
                    and rep["residual_norm_total"] > 0):
                raise AssertionError(f"the PowerSGD step: {rep}")
        finally:
            acc = model = params = first = state = None
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rep


def fa_launches(name: str) -> int:
    from accelerate_tpu_torch.ops import flash_attention as fa

    return fa._WRAPPERS[name].launches


def parallel_phase(torch, fa, card: str) -> dict:
    """Step 6e: (a)-(e) and (g); returns each and the launches of one ring
    pass, one Ulysses pass, one tp step in each mode, one pipelined step,
    (g)'s rank passes and its PowerSGD steps."""
    one = world_of_one(torch, card)
    ring = virtual_ring(torch, fa, card)
    uly = virtual_ulysses(torch, fa, card, ring)
    tp = virtual_tp(torch, fa, card)
    pipe = virtual_pp(torch, fa, card)
    dcn = virtual_dcn(torch, fa, card)
    psgd = powersgd_world_of_one(torch, card)
    return {"world_of_one": one, "ring": ring, "ulysses": uly, "tp": tp, "pp": pipe,
            "dcn": dcn, "powersgd": psgd,
            "launches": ring["causal"]["launches"],
            "ulysses_launches": uly["causal"]["launches"],
            "tp_launches": {n: sum(tp[m]["launches"][n] for m in TP["modes"])
                            for n in FLASH_REPLACES},
            "pp_launches": pipe["launches"], "dcn_launches": dcn["launches"],
            "powersgd_launches": psgd["launches"]}


# (f) the Mixtral MoE family: Mixtral 8x7B's published widths (vocab 32000,
# hidden 4096, intermediate 14336, 32 q / 8 kv heads of 128, rope theta
# 1e6, 8 experts, top 2, capacity factor 1.25), depth cut to 2 of 32
# layers; the 600m step's recipe (bf16, bf16 gradients, lion-sr)
MOE = dict(layers=2, batch=4, seq=1024, ep=4, warmup=1, timed=3, optimizer="lion-sr")


def moe_setup(torch, device: str = "cuda"):
    from accelerate_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=MOE["layers"],
                                     attn_implementation="flash", dtype=torch.bfloat16)
    model = MixtralForCausalLM(cfg, device=device, seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE["batch"], MOE["seq"]))).to(device)
    return cfg, model, {"input_ids": ids, "labels": ids}


@contextlib.contextmanager
def recorded_routing(mixtral_mod, calls: list):
    """Record every routing the Mixtral layers compute (the dispatch mask
    and the tokens' count)."""
    saved = mixtral_mod.top_k_routing

    def record(logits, *a, **k):
        out = saved(logits, *a, **k)
        calls.append({"dispatch": out.dispatch.detach(), "tokens": logits.shape[0]})
        return out

    mixtral_mod.top_k_routing = record
    try:
        yield
    finally:
        mixtral_mod.top_k_routing = saved


def moe_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """(f): Mixtral at 8x7B's widths, 2 layers.  (f2) first, on the initial
    weights: the fwd + bwd over a virtual ep 4 world (2 experts a rank,
    each rank its module replica on its expert slices) against the
    unsharded fwd + bwd, the first layer's dispatch masks against the
    unsharded forward's bitwise, every launch held to its plain version,
    the ranks' leaves laid out by the train state's plan under ep
    (``DataParallelPlan``), its step on each rank's gradients (reduce,
    global norm over ep, lion-sr update, write-back) bitwise the whole
    tree's update; then (f1) the Accelerator's train step: launches, every launch
    held to its plain version, router losses, dropped share, step ms,
    tokens/s, MFU on the active parameters, peak memory."""
    from accelerate_tpu_torch import Accelerator, GradSyncKwargs
    from accelerate_tpu_torch.accelerator import global_norm
    from accelerate_tpu_torch.models import mixtral as mixtral_mod
    from accelerate_tpu_torch.models.mixtral import (
        collect_router_losses, count_active_params, is_expert_leaf, make_mixtral_loss_fn,
    )
    from accelerate_tpu_torch.optimizer import make_optimizer
    from accelerate_tpu_torch.parallel.fsdp import DataParallelPlan, parallel_align
    from accelerate_tpu_torch.parallel.sharding import tp_rules_for
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    cfg, model, batch = moe_setup(torch, device)
    ep, layers = MOE["ep"], cfg.num_hidden_layers
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach() for n, p in model.named_parameters()}
    loss_fn = make_mixtral_loss_fn(model)
    tokens = MOE["batch"] * MOE["seq"]
    out = {"card": card, "shape": {"layers": layers, "batch": MOE["batch"], "seq": MOE["seq"],
                                   "experts": cfg.num_local_experts,
                                   "top_k": cfg.num_experts_per_tok,
                                   "capacity_factor": cfg.capacity_factor,
                                   "head_dim": cfg.head_dim},
           "params": sum(p.numel() for p in params.values()),
           "active_params": count_active_params(cfg)}

    # the unsharded reference and its routing
    routes: list = []
    with recorded_routing(mixtral_mod, routes), collect_router_losses() as sown:
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = loss_fn(leaves, batch)
        ref = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
    del leaves, loss
    capacity = routes[0]["dispatch"].shape[-1]
    kept = [int(r["dispatch"].sum()) for r in routes]
    out["routing"] = {"capacity": capacity,
                      "dropped_share": [1 - k / (tokens * cfg.num_experts_per_tok)
                                        for k in kept],
                      "aux_loss": [x.item() for x in sown["router_aux_loss"]],
                      "z_loss": [x.item() for x in sown["router_z_loss"]]}
    if len(out["routing"]["aux_loss"]) != layers or not all(
            math.isfinite(x) for x in out["routing"]["aux_loss"] + out["routing"]["z_loss"]):
        raise AssertionError(f"moe: router losses not finite: {out['routing']}")
    log("moe routing:", json.dumps({k: out[k] for k in ("shape", "params", "active_params",
                                                         "routing")}))

    # (f2) the virtual ep world, its leaves laid out by the train state's
    # plan under ep (Accelerator.create_train_state's DataParallelPlan over
    # the MoE rules: each rank its E / ep experts, the rest whole)
    mesh = VirtualMesh(*_layout(ep=ep))
    pcfg = ParallelismConfig(ep_size=ep)
    plans = mesh.run(lambda r: DataParallelPlan(mesh, pcfg, None, params,
                                                align=parallel_align(None),
                                                tp_rules=tp_rules_for(pcfg)), pcfg)
    shards = mesh.run(lambda r: plans[r].shard_params(params), pcfg)
    split = [n for n in names if plans[0].layouts[n].tp_dim is not None]
    if split != [n for n in names if is_expert_leaf(n)] or any(
            plans[0].layouts[n].model_axis != "ep" or not torch.equal(
                shards[r][n], params[n].chunk(ep, dim=0)[r])
            for n in split for r in range(ep)):
        raise AssertionError(f"moe ep: the plan does not split the expert leaves over ep: "
                             f"{split}")
    replicas = [module_replica(model) for _ in range(ep)]
    rank_loss = [make_mixtral_loss_fn(m) for m in replicas]

    def sharded(record=None):
        leaves = [{n: t.detach().requires_grad_() for n, t in s.items()} for s in shards]
        with recorded_routing(mixtral_mod, record if record is not None else []):
            losses = mesh.run(lambda r: rank_loss[r](leaves[r], batch).float(), pcfg)
        flat = torch.autograd.grad(losses, [t for lv in leaves for t in lv.values()])
        by_rank = [flat[r * len(names):(r + 1) * len(names)] for r in range(ep)]
        grads = [torch.cat([by_rank[r][i] for r in range(ep)]) if n in split
                 else by_rank[0][i] for i, n in enumerate(names)]
        return losses[0].detach(), grads, [x.item() for x in losses], by_rank

    reset_counts()
    ep_routes: list = []
    got = sharded(ep_routes)
    sync(torch)
    counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
    if any(c != ep * layers for c in counts.values()):
        raise AssertionError(f"moe ep: launches {counts}, want {ep * layers} each")
    f2 = {"launches": counts, "collectives": dict(mesh.calls),
          "vs_unsharded": grads_against(torch, "moe ep", names, got[:2], ref),
          "ranks_loss_spread": max(got[2]) - min(got[2]),
          "first_layer_dispatch_equal": bool(torch.equal(ep_routes[0]["dispatch"],
                                                          routes[0]["dispatch"])),
          # rank 0's routing of each layer against the unsharded forward's
          "dispatch_equal_by_layer": [bool(torch.equal(ep_routes[i * ep]["dispatch"],
                                                       routes[i]["dispatch"]))
                                      for i in range(layers)]}
    del ref
    if not f2["first_layer_dispatch_equal"]:
        raise AssertionError("moe ep: the first layer's dispatch differs from the unsharded "
                             "forward's")
    # the plan's step on each rank's gradients (reduce, the global norm
    # over ep, the lion-sr update of the rank's leaves under the whole
    # leaves' salts, the write-back) against the whole tree's update on
    # the re-assembled gradients: the expert slices and rank 0's replicated
    # leaves bitwise
    tx = make_optimizer(MOE["optimizer"])
    new_w, st_w = tx.update(got[1], tx.init(list(params.values())), list(params.values()))
    by_rank = got[3]

    def plan_step(r):
        plan = plans[r]
        grads = plan.reduce_grads(list(by_rank[r]))
        gnorm = plan.global_norm(grads, global_norm)
        stored = {n: t.clone() for n, t in shards[r].items()}
        leaves = plan.opt_params(stored)
        new, st = tx.update(grads, tx.init(leaves), leaves, numels=plan.numels)
        plan.write_back(stored, new)
        same = {}
        for i, n in enumerate(names):
            if n in split or r == 0:
                want_p, want_m = new_w[i], st_w.mu[i]
                if n in split:
                    want_p, want_m = want_p.chunk(ep, 0)[r], want_m.chunk(ep, 0)[r]
                same[n] = bool(torch.equal(stored[n], want_p) and torch.equal(st.mu[i], want_m))
        return gnorm.item(), same

    stepped = mesh.run(plan_step, pcfg)
    whole_norm = global_norm(list(got[1])).item()
    f2["plan_step"] = {
        "grad_norm": [g for g, _ in stepped], "whole_grad_norm": whole_norm,
        "grad_norm_rel": max(abs(g - whole_norm) for g, _ in stepped) / whole_norm,
        "expert_update_bitwise": all(same[n] for _, same in stepped for n in split),
        "replicated_update_bitwise_rank0": all(v for n, v in stepped[0][1].items()
                                               if n not in split),
        "replicated_grads_bitwise_across_ranks": all(
            torch.equal(by_rank[r][i], by_rank[0][i])
            for r in range(1, ep) for i, n in enumerate(names) if n not in split)}
    del new_w, st_w, by_rank
    f2["expert_sr_update_bitwise"] = f2["plan_step"]["expert_update_bitwise"]
    if not (f2["plan_step"]["expert_update_bitwise"]
            and f2["plan_step"]["replicated_update_bitwise_rank0"]
            and f2["plan_step"]["grad_norm_rel"] <= GNORM_RTOL):
        raise AssertionError(f"moe ep: the plan's step is not the whole tree's: "
                             f"{f2['plan_step']}")
    del got
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        sharded()
    f2["in_path"] = worst_of(readings, {n: ep * layers for n in FLASH_REPLACES})

    def unsharded():
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = loss_fn(leaves, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    ms = {"unsharded": [], "ep": []}
    for _ in range(MOE["timed"]):
        for label, fn in (("unsharded", unsharded), ("ep", sharded)):
            sync(torch)
            t0 = time.perf_counter()
            res = fn()
            sync(torch)
            ms[label].append((time.perf_counter() - t0) * 1e3)
            del res
    f2["fwd_bwd_ms"] = ms
    f2["median_ms"] = {k: float(np.median(v[1:] if len(v) > 1 else v)) for k, v in ms.items()}
    f2["ep_over_unsharded"] = f2["median_ms"]["ep"] / f2["median_ms"]["unsharded"]
    f2["ep_profile"] = profiled_step(torch, sharded, top=8)
    out["ep"] = f2
    log("moe (f2) virtual ep:", json.dumps(f2))
    del replicas, shards, plans
    torch.cuda.empty_cache()

    # (f1) the Accelerator's train step on one rank
    acc = Accelerator(mixed_precision="bf16", device=device,
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    state = acc.create_train_state(params, MOE["optimizer"])
    step = acc.prepare_train_step(loss_fn)
    reset_counts()
    state, metrics = step(state, batch)
    sync(torch)
    counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
    if any(c != layers for c in counts.values()):
        raise AssertionError(f"moe step: launches {counts}, want {layers} each")
    f1 = {"launches": counts, "first_loss": metrics["loss"].item()}
    state, f1["in_path"] = checked_step(torch, fa, acc, loss_fn, state, batch, layers)
    for _ in range(MOE["warmup"]):
        state, metrics = step(state, batch)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(MOE["timed"]):
        sync(torch)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync(torch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe step: losses not finite: {losses}")
    step_s = float(np.median(step_ms)) / 1e3
    flops = (6 * out["active_params"]
             + 12 * layers * cfg.num_attention_heads * cfg.head_dim * MOE["seq"])
    f1.update(step_ms=step_ms, median_step_ms=step_s * 1e3, losses=losses,
              tokens_per_s=tokens / step_s, flops_per_token=flops,
              mfu_vs_989_tflops=flops * tokens / step_s / BF16_FLOPS_PER_S,
              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
              ep_over_step_fwd_bwd=f2["median_ms"]["ep"] / f2["median_ms"]["unsharded"])

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    f1["profile"] = profiled_step(torch, one_step, top=10)
    out["step"] = f1
    log("moe (f1) step:", json.dumps(f1))
    del state, step, params, model
    torch.cuda.empty_cache()
    out["launches"] = f1["launches"]
    out["ep_launches"] = f2["launches"]
    return out


# -- the two-process serving fabric and sharded checkpoints (6g, 6h) ---------------

# the fabric's roles: JAX's independent geometries at the 600m serving
# engine's page geometry, int8 pages; every request arrives at once with no
# deadline and no EOS, so each ships its pages exactly once
FABRIC = dict(requests=8, new_tokens=(32, 64), kv_dtype="int8", timeout=900)
FABRIC_SHARED = dict(page_size=PLUGIN["page_size"], pages_per_slot=PLUGIN["pages_per_slot"],
                     default_deadline_ticks=0)
FABRIC_PREFILL = dict(num_slots=4, num_pages=96, prefill_chunk=512, speculate="off")
FABRIC_DECODE = dict(num_slots=8, num_pages=160, prefill_chunk=256, speculate="ngram",
                     speculate_k=2)


def fabric_trace(torch):
    import dataclasses

    from accelerate_tpu_torch import synthesize_trace

    return [dataclasses.replace(r, arrival_step=0, deadline_ticks=0)
            for r in synthesize_trace(0, FABRIC["requests"],
                                      **dict(TRACE, new_tokens_range=FABRIC["new_tokens"]))]


def fabric_worker(rank: int, world: int, device: str = "cpu") -> dict:
    """One process of the fabric (``test_utils/gang.run_gang`` on a gloo
    world whose two processes both compute on ``device``): the 600m model
    (random weights from seed 0) in the role of this rank through
    ``fleet_fabric.serve_fabric``, the resource contract checked after
    every tick, each kernel's launches counted from the warm engine to the
    end of its rounds; rank 1 holds its tokens to the fused serve's by the
    token rule and then runs one checked pass of the same trace with the
    decode plugin (every #5 / #7 launch against its plain version)."""
    import torch
    import torch.distributed as dist

    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingPlugin
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm
    from accelerate_tpu_torch.serving import verify_serving_invariants
    from accelerate_tpu_torch.test_utils.scripts.fleet_fabric import serve_fabric

    on_card = torch.device(device).type == "cuda"
    # the kernel libraries build once: one process after the other (the
    # script built them before starting the gang; this finds them in build/)
    for r in range(world):
        if r == rank and on_card:
            _build.build_all(["paged_decode", "paged_prefill"])
        dist.barrier()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    trace = fabric_trace(torch)
    kv = FABRIC["kv_dtype"]
    prefill = ServingPlugin(**FABRIC_SHARED, **FABRIC_PREFILL, kv_dtype=kv)
    decode = ServingPlugin(**FABRIC_SHARED, **FABRIC_DECODE, kv_dtype=kv)
    gen = GenerationConfig(max_new_tokens=FABRIC["new_tokens"][1], eos_token_id=None)
    seen: dict = {"ticks": 0}

    def on_tick(engine):
        seen["ticks"] += 1
        problems = verify_serving_invariants(engine)
        if problems:
            raise AssertionError(f"fabric rank {rank} tick {seen['ticks']}: {problems}")

    def on_phase(name, engine):
        if name == "warm":
            reset_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
        else:
            seen["launches"] = launch_counts()
            seen["metrics"] = dict(engine.metrics)

    rule: dict = {}

    def judge(got, fused):
        rule.update(token_rule(torch, model, llama_mod, fa, qmm, trace, fused, got,
                               kv_dtype=kv, label="fleet_fabric"))
        return True

    out = serve_fabric(rank, model, prefill, decode, gen, trace, device=device, on_tick=on_tick,
                       on_phase=on_phase, judge=judge)
    layers = cfg.num_hidden_layers
    m = seen["metrics"]
    want = {"paged_multitoken_attention_quant":
            (m["prefill_steps"] + m.get("verify_steps", 0)) * layers,
            "paged_decode_attention_quant": m["decode_steps"] * layers}
    if on_card:
        expect_launches(seen["launches"], {k: v for k, v in want.items() if v})
    out.update(launches={k: v for k, v in seen["launches"].items() if v}, expected=want,
               invariants_checked_ticks=seen["ticks"],
               peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else 0,
               tick_kinds={k: m.get(k, 0) for k in ("prefill_steps", "decode_steps",
                                                    "verify_steps")})
    if rank == 1:
        out["token_rule"] = rule
        out.pop("results"), out.pop("fused")
        out["in_path"] = in_path_check(
            torch, model, llama_mod, fa, qmm, trace, kv_dtype=kv,
            plugin=dict(FABRIC_SHARED, **FABRIC_DECODE), invariants=True,
            required=["paged_multitoken_attention"])
    return out


def fleet_fabric_phase(torch, card: str, device: str = "cuda:0",
                       worker: str = "chip_smoke:fabric_worker") -> dict:
    """(6g) The two-process fabric on one card: rank 0 the prefill role,
    rank 1 the decode role (n-gram speculation, k 2), over int8 pages,
    their wire gloo on the host; each process on ``device``.  Checks every
    request finished, bytes sent = received = ``transfer_accounting``
    exactly, the per-role launch counts, the token rule, the checked pass
    and the contract; prints the wire's ms and GB/s a request, TTFT and
    tokens/s beside the in-process int8 pair's, and each process's peak
    memory."""
    import tempfile

    from accelerate_tpu_torch.test_utils.gang import run_gang

    work = tempfile.mkdtemp(prefix="fleet_fabric_")
    t0 = time.perf_counter()
    prefill, decode = run_gang(worker, 2, work, timeout=FABRIC["timeout"], device=device)
    wall = time.perf_counter() - t0
    fleet = prefill["fleet"]
    n = FABRIC["requests"]
    per_req = prefill["wire_bytes"] / n
    send_ms = [1e3 * s for s in prefill["wire_s"]]
    recv_ms = [1e3 * s for s in decode["wire_s"]]
    ttft = sorted(1e3 * s for s in prefill["first_token_s"].values())
    e2e_s = decode["recv_s"] + decode["decode_s"]
    pair = PAIR_REPORTS.get("disaggregate_int8")
    out = {"card": card, "requests": n, "kv_dtype": FABRIC["kv_dtype"],
           "bytes_pred": prefill["bytes_pred"], "bytes_sent": prefill["bytes_sent"],
           "bytes_recv": decode["bytes_recv"], "bytes_per_page": prefill["bytes_per_page"],
           "wire_bytes_per_request": per_req,
           "wire_send_ms_mean": sum(send_ms) / n, "wire_recv_ms_mean": sum(recv_ms) / n,
           "wire_send_gb_s": per_req / (sum(send_ms) / n) / 1e6,
           "wire_recv_gb_s": per_req / (sum(recv_ms) / n) / 1e6,
           "ttft_p50_ms": ttft[len(ttft) // 2], "prefill_serve_s": prefill["serve_s"],
           "decode_tokens": decode["tokens"], "decode_s": decode["decode_s"],
           "recv_s": decode["recv_s"], "decode_tokens_per_sec": decode["tokens"] / decode["decode_s"],
           "tokens_per_sec_from_first_recv": decode["tokens"] / e2e_s,
           "pair_int8": ({k: pair[k] for k in ("tokens_per_sec", "wall_s", "requests",
                                               "ttft_p50_ms") if k in pair}
                         if pair else None),
           "launches": {"prefill": prefill["launches"], "decode": decode["launches"]},
           "tick_kinds": {"prefill": prefill["tick_kinds"], "decode": decode["tick_kinds"]},
           "invariants_checked_ticks": {"prefill": prefill["invariants_checked_ticks"],
                                        "decode": decode["invariants_checked_ticks"]},
           "peak_bytes": {"prefill": prefill["peak_bytes"], "decode": decode["peak_bytes"]},
           "token_rule": decode["token_rule"], "in_path": decode["in_path"], "fleet": fleet,
           "gang_wall_s": wall}
    log("fleet_fabric", json.dumps(out))
    log(f"fleet_fabric on {card}: {n} requests, {out['bytes_sent']} bytes sent = received = "
        f"predicted; wire {per_req / 1e6:.2f} MB a request, send {out['wire_send_ms_mean']:.2f} "
        f"ms ({out['wire_send_gb_s']:.3f} GB/s), recv {out['wire_recv_ms_mean']:.2f} ms; TTFT "
        f"p50 {out['ttft_p50_ms']:.1f} ms; {out['decode_tokens_per_sec']:.1f} decode tokens/s "
        f"(in-process int8 pair: {pair['tokens_per_sec'] if pair else 'not run'}); peak "
        f"{prefill['peak_bytes'] / 2**30:.2f} / {decode['peak_bytes'] / 2**30:.2f} GiB")
    if not (prefill["bytes_sent"] == prefill["bytes_recv"] == decode["bytes_recv"]
            == prefill["bytes_pred"] > 0):
        raise AssertionError(f"fleet_fabric bytes: sent {prefill['bytes_sent']}, received "
                             f"{decode['bytes_recv']}, predicted {prefill['bytes_pred']}")
    if prefill["completed"] != FABRIC["requests"] or not prefill["parity"]:
        raise AssertionError(f"fleet_fabric: {prefill['completed']} requests finished, "
                             f"verdict {prefill['parity']}")
    if fleet["goodput_frac"] != 1.0 or fleet["routed_by_prefix"] <= 0:
        raise AssertionError(f"fleet_fabric router smoke: {fleet}")
    return out


SHARDED = dict(ranks=4, restore_ranks=2, batch=4, optimizer="lion-sr")


def checked_step_metrics(torch, fa, acc, loss_fn, state, batch, layers: int):
    """:func:`checked_step` with the step's metrics."""
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        state, m = acc.prepare_train_step(loss_fn)(state, batch)
    return state, m, worst_of(readings, {n: layers for n in FLASH_REPLACES})


def _mesh_of(dp_shard: int):
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    names, shape = _layout(dp_shard=dp_shard)
    return VirtualMesh(names, shape), ParallelismConfig(dp_shard_size=dp_shard)


def _payload_bytes(path: Path) -> int:
    from accelerate_tpu_torch.utils.serialization import read_safetensors_header

    header, _ = read_safetensors_header(path)
    return sum(v["data_offsets"][1] - v["data_offsets"][0] for k, v in header.items()
               if k != "__metadata__")


def _predicted_rank_bytes(plan, state) -> int:
    """The bytes a rank writes of params and momentum, from its layouts
    alone: its range of each sharded leaf less the padding, a replicated
    leaf on rank 0 only."""
    from accelerate_tpu_torch.parallel import collectives

    total = 0
    first = collectives.axis_index("dp_shard", plan.mesh) == 0
    for (name, p), mu in zip(state.params.items(), state.opt_state.mu):
        lay = plan.layouts[name]
        if lay.sharded:
            k = collectives.axis_index(lay.opt_axes, plan.mesh)
            n = max(0, min(lay.chunk, lay.numel - k * lay.chunk))
        else:
            n = lay.numel if first else 0
        total += n * (p.element_size() + mu.element_size())
    return total


def sharded_ckpt_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """(6h) The 600m train state (bf16 params, lion-sr momentum) after 2
    steps at 4 x 2048 in one process (the second's #1-#3 held to plain),
    laid out under FULL_SHARD over a virtual world of 4 ranks in this
    process (each rank restored from the one-process checkpoint), each
    rank's own save (synchronous, then asynchronous: snapshots, then the
    four writes at once), the bytes a rank wrote against its layouts',
    restores onto 2 virtual ranks and onto one process, bitwise against the
    state (params and momentum), ``merge_weights`` against ``save_model``,
    and one more step on the restored process bitwise the step on the
    state it was saved from (#1-#3 held to plain)."""
    import concurrent.futures
    import shutil
    import tempfile

    from accelerate_tpu_torch.checkpointing import (
        _ShardSnapshot, load_train_state, merge_weights, save_model, save_train_state,
    )
    from accelerate_tpu_torch.native import file_crc32
    from accelerate_tpu_torch.parallel.fsdp import DataParallelPlan, parallel_align
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    cfg, model, params, acc, loss_fn = train_setup(torch, device=device)
    layers = cfg.num_hidden_layers
    state = acc.create_train_state(params, SHARDED["optimizer"])
    step = acc.prepare_train_step(loss_fn)
    batch = token_batch(torch, cfg.vocab_size, SHARDED["batch"], device=device)
    reset_counts()
    state, m1 = step(state, batch)
    launches = {n: fa_launches(n) for n in FLASH_REPLACES}
    if any(v != layers for v in launches.values()):
        raise AssertionError(f"sharded_ckpt: step launches {launches}, {layers} each expected")
    state, m2, held = checked_step_metrics(torch, fa, acc, loss_fn, state, batch, layers)
    sync(torch)
    plugin = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD")
    align = parallel_align(plugin)
    root = Path(tempfile.mkdtemp(prefix="sharded_ckpt_"))
    out = {"card": card, "world": SHARDED["ranks"], "virtual": True,
           "state_bytes": sum(p.numel() * p.element_size() for p in state.params.values())
           + sum(m.numel() * m.element_size() for m in state.opt_state.mu),
           "loss": [m1["loss"].item(), m2["loss"].item()], "in_path": held}
    try:
        t0 = time.perf_counter()
        save_train_state(root / "whole" / "train_state", state)
        out["whole_save_ms"] = 1e3 * (time.perf_counter() - t0)

        def zeros_template(plan):
            stored = {n: torch.zeros_like(t) for n, t in plan.shard_params(state.params).items()}
            return state.replace(params=stored, opt_state=state.tx.init(plan.opt_params(stored)),
                                 rng=torch.Generator(device=device))

        def same_as_state(plan, got):
            """Each stored tensor bitwise the plan's layout of the state."""
            want_p = plan.shard_params(state.params)
            mu = dict(zip(state.params, state.opt_state.mu))
            want_m = plan.opt_params(plan.shard_params(mu))
            return (all(torch.equal(got.params[n], w) for n, w in want_p.items())
                    and all(torch.equal(a, b) for a, b in zip(got.opt_state.mu, want_m))
                    and got.opt_state.count == state.opt_state.count)

        mesh4, pcfg4 = _mesh_of(SHARDED["ranks"])

        def lay_out(r):
            plan = DataParallelPlan(mesh4, pcfg4, plugin, state.params, align=align)
            template = zeros_template(plan)
            sync(torch)
            t = time.perf_counter()
            mine = load_train_state(root / "whole" / "train_state", template, plan)
            sync(torch)
            return plan, mine, 1e3 * (time.perf_counter() - t)

        ranks = mesh4.run(lay_out, pcfg4)
        shutil.rmtree(root / "whole")
        out["restore_1_to_4_ms"] = [ms for _, _, ms in ranks]
        out["laid_out_bitwise"] = all(mesh4.run(lambda r: same_as_state(*ranks[r][:2]), pcfg4))

        def rank_save(r):
            plan, mine, _ = ranks[r]
            sync(torch)
            t = time.perf_counter()
            written = save_train_state(root / "sync" / "train_state", mine, plan)
            ms = 1e3 * (time.perf_counter() - t)
            shard = root / "sync" / "train_state" / f"shard_{r:05d}.safetensors"
            return {"ms": ms, "file_bytes": written, "payload": _payload_bytes(shard),
                    "predicted": _predicted_rank_bytes(plan, mine)}

        saves = mesh4.run(rank_save, pcfg4)
        if any(s["payload"] != s["predicted"] for s in saves):
            raise AssertionError(f"sharded_ckpt: bytes a rank wrote vs predicted: {saves}")

        def snapshot(r):
            plan, mine, _ = ranks[r]
            t = time.perf_counter()
            snap = _ShardSnapshot(mine, plan, [])
            return snap, 1e3 * (time.perf_counter() - t)

        t = time.perf_counter()
        snaps = mesh4.run(snapshot, pcfg4)
        with concurrent.futures.ThreadPoolExecutor(len(snaps)) as pool:
            list(pool.map(lambda s: s[0].write(root / "async" / "train_state"), snaps))
        async_total_ms = 1e3 * (time.perf_counter() - t)
        async_blocking_ms = [ms for _, ms in snaps]
        files = sorted(p.name for p in (root / "sync" / "train_state").iterdir())
        same_files = all(file_crc32(root / "sync" / "train_state" / f)
                         == file_crc32(root / "async" / "train_state" / f) for f in files)
        shutil.rmtree(root / "async")
        del ranks, snaps
        mesh2, pcfg2 = _mesh_of(SHARDED["restore_ranks"])

        def restore2(r):
            plan = DataParallelPlan(mesh2, pcfg2, plugin, state.params, align=align)
            template = zeros_template(plan)
            sync(torch)
            t = time.perf_counter()
            got = load_train_state(root / "sync" / "train_state", template, plan)
            sync(torch)
            ms = 1e3 * (time.perf_counter() - t)
            return ms, same_as_state(plan, got), sum(
                p.numel() * p.element_size() for p in got.params.values()) + sum(
                m.numel() * m.element_size() for m in got.opt_state.mu)

        restored2 = mesh2.run(restore2, pcfg2)
        zeros = {n: torch.zeros_like(p) for n, p in state.params.items()}
        one = state.replace(params=zeros, opt_state=state.tx.init(list(zeros.values())),
                            rng=torch.Generator(device=device))
        sync(torch)
        t = time.perf_counter()
        one = load_train_state(root / "sync" / "train_state", one)
        sync(torch)
        one_ms = 1e3 * (time.perf_counter() - t)
        one_bitwise = (all(torch.equal(one.params[n], p) for n, p in state.params.items())
                       and all(torch.equal(a, b) for a, b in zip(one.opt_state.mu,
                                                                 state.opt_state.mu))
                       and torch.equal(one.rng.get_state(), state.rng.get_state()))
        t = time.perf_counter()
        merged = merge_weights(str(root / "sync"), str(root / "merged"))
        merge_ms = 1e3 * (time.perf_counter() - t)
        want = save_model(None, state.params, str(root / "model"), max_shard_size=f"{2**40}B")[0]
        merged_equal = (Path(merged).stat().st_size == Path(want).stat().st_size
                        and file_crc32(merged) == file_crc32(want))
        # one more step on each: the restored process and the state it was
        # saved from
        one, m_one, held_one = checked_step_metrics(torch, fa, acc, loss_fn, one, batch, layers)
        state, m_ref, held_ref = checked_step_metrics(torch, fa, acc, loss_fn, state, batch,
                                                      layers)
        step_bitwise = (m_one["loss"].item() == m_ref["loss"].item()
                        and all(torch.equal(one.params[n], p) for n, p in state.params.items()))
        out["loss"] += [m_ref["loss"].item(), m_one["loss"].item()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rank_gb = [s["payload"] / s["ms"] / 1e6 for s in saves]
    out.update({
        "save_sync": saves, "save_sync_gb_s": rank_gb,
        "save_async_blocking_ms": async_blocking_ms,
        "save_async_total_ms": async_total_ms, "async_files_equal_sync": same_files,
        "restore_4_to_2_ms": [ms for ms, _, _ in restored2],
        "restore_4_to_2_gb_s": [b / ms / 1e6 for ms, _, b in restored2],
        "restore_4_to_2_bitwise": all(ok for _, ok, _ in restored2),
        "restore_4_to_1_ms": one_ms,
        "restore_4_to_1_gb_s": out["state_bytes"] / one_ms / 1e6,
        "restore_4_to_1_bitwise": one_bitwise, "merge_ms": merge_ms,
        "merge_equals_save_model": merged_equal, "next_step_bitwise": step_bitwise,
        "in_path_after_restore": held_one, "launches": launches})
    bad = [k for k in ("laid_out_bitwise", "async_files_equal_sync", "restore_4_to_2_bitwise",
                       "restore_4_to_1_bitwise", "merge_equals_save_model", "next_step_bitwise")
           if not out[k]]
    if bad:
        raise AssertionError(f"sharded_ckpt: {bad} failed: {out}")
    log("sharded_ckpt", json.dumps(out))
    return out


RECIPES_6I = dict(ranks=4, steps=2, optimizer="lion-sr8", modes=("True", "False", "whole"))


def _recipe_world(torch, pcfg, start, replicas, *, plugin, mixed_precision="bf16",
                  wrap=None, device="cuda"):
    """Every rank of a virtual world of ``pcfg``: its Accelerator (bf16
    gradients, the 600m recipe), train state over ``start`` and prepared
    step, each rank's loss on its own module replica (``wrap`` applied)."""
    from accelerate_tpu_torch import Accelerator, GradSyncKwargs, make_llama_loss_fn
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh

    mesh = VirtualMesh(*pcfg.mesh_layout(RECIPES_6I["ranks"]))

    def make(r):
        acc = Accelerator(mixed_precision=mixed_precision, device=device,
                          parallelism_config=pcfg, fsdp_plugin=plugin,
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        state = acc.create_train_state({n: p.clone() for n, p in start.items()},
                                       RECIPES_6I["optimizer"])
        loss_fn = make_llama_loss_fn(replicas[r], fused_vocab_chunks=TRAIN["ce_chunks"])
        return [acc, state, acc.prepare_train_step(wrap(loss_fn) if wrap else loss_fn)]

    return mesh, mesh.run(make, pcfg)


def _recipe_step(torch, mesh, pcfg, ranks, ids) -> tuple[list, float]:
    """One step of every rank on its rows of ``ids``: the ranks' metrics
    and the step's ms (host clock to a device sync)."""
    from accelerate_tpu_torch.data_loader import shard_global_batch

    def one(r):
        acc, state, step = ranks[r]
        local = shard_global_batch(ids, acc.mesh, pcfg.batch_spec(seq_axis=None, ndim=2))
        ranks[r][1], m = step(state, {"input_ids": local, "labels": local})
        return m

    sync(torch)
    t0 = time.perf_counter()
    metrics = mesh.run(one, pcfg)
    sync(torch)
    return metrics, 1e3 * (time.perf_counter() - t0)


def _rank_snapshot(state) -> list:
    return [p.detach().to("cpu", copy=True) for p in state.params.values()] + \
        [t.detach().to("cpu", copy=True) for t in opt_tensors(state)]


def sharded_recipes_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """(6i) the sharded step's memory and precision recipes on the 600m at
    full widths and depth over a virtual world of 4, FULL_SHARD, one row of
    2048 a rank.  (a) per-unit gathering: ``reshard_after_forward`` True
    and False and the whole-tree step (the loss without its model's
    units), 2 lion-sr8 steps each from one state: #1-#3's launches of the
    first step counted and each held to plain, the memory the second step
    adds after the forward and at its peak and its ms, losses, params,
    codes and scales bitwise across the three; (b) ZeRO-offload of each rank's
    ranges: one monolithic step bitwise the resident plan step (the first
    step of (a)'s ``True``), one chunked pipelined step (the same loss; its
    salts are group-relative), each rank's D2H / H2D bytes against
    ``offload_transfer_accounting`` of its ranges and its host-update ms;
    (c) fp8 delayed scaling under dp 4 and under tp 2 x dp_shard 2, one step
    each beside bf16: the metas bitwise equal on every rank, every
    ``torch._scaled_mm`` product of a second step held to its plain
    version (``FP8_MM_RTOL`` of each row's largest sum of |terms|; the
    error against each row's largest value beside it), tokens/s."""
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import fp8 as fp8_mod
    from accelerate_tpu_torch.ops import precision as prec
    from accelerate_tpu_torch.ops.streaming import offload_transfer_accounting
    from accelerate_tpu_torch.parallel.virtual import module_replica
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    world = RECIPES_6I["ranks"]
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    start = {n: p.detach().to(torch.bfloat16).clone() for n, p in model.named_parameters()}
    replicas = [module_replica(model) for _ in range(world)]
    del model
    ids = token_batch(torch, cfg.vocab_size, world, device)["input_ids"]
    layers = cfg.num_hidden_layers
    dp4 = ParallelismConfig(dp_shard_size=world)
    out = {"card": card, "world": world, "virtual": True, "rows_a_rank": 1,
           "seq": TRAIN["seq"], "optimizer": RECIPES_6I["optimizer"]}

    # (a) per-unit gathering against the whole-tree step
    finals, first_resident, mem = {}, None, {}
    for mode in RECIPES_6I["modes"]:
        after_forward: list = []

        def wrap(loss_fn, after_forward=after_forward, mode=mode):
            def measured(params, batch):
                loss = loss_fn(params, batch)
                after_forward.append(torch.cuda.memory_allocated())
                return loss

            if mode != "whole":
                measured.fsdp_units = loss_fn.fsdp_units
            return measured

        plugin = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD",
                                                reshard_after_forward=mode != "False")
        mesh, ranks = _recipe_world(torch, dp4, start, replicas, plugin=plugin, wrap=wrap,
                                    device=device)
        # the first step counted, every launch held to plain (the plain
        # versions launch no kernel); the second measured
        readings = {n: [] for n in FLASH_REPLACES}
        reset_counts()
        with checked_flash_kernels(torch, fa, readings):
            metrics, ms1 = _recipe_step(torch, mesh, dp4, ranks, ids)
        launches = {n: fa_launches(n) for n in FLASH_REPLACES}
        if any(v != world * layers for v in launches.values()):
            raise AssertionError(f"sharded_recipes {mode}: launches {launches}, "
                                 f"{world * layers} each expected")
        if mode == "True":
            PATH_LAUNCHES["sharded_recipes"] = launches
            first_resident = [_rank_snapshot(r[1]) for r in ranks]
        sync(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        after_forward.clear()
        metrics2, ms = _recipe_step(torch, mesh, dp4, ranks, ids)
        peak = torch.cuda.max_memory_allocated()
        mem[mode] = {"after_forward_gb": (max(after_forward) - base) / 1e9,
                     "peak_gb": (peak - base) / 1e9, "state_gb": base / 1e9,
                     "step_ms": ms, "checked_step_ms": ms1, "launches": launches,
                     "in_path": worst_of(readings, {n: world * layers for n in FLASH_REPLACES}),
                     "loss": [metrics[0]["loss"].item(), metrics2[0]["loss"].item()]}
        finals[mode] = [_rank_snapshot(r[1]) for r in ranks]
        log("sharded_recipes (a)", mode, json.dumps(mem[mode]))
        del ranks, mesh
        torch.cuda.empty_cache()
    out["per_unit"] = mem
    out["per_unit_bitwise"] = {
        mode: all(all_equal(torch, a, b) for a, b in zip(finals[mode], finals["whole"]))
        and mem[mode]["loss"] == mem["whole"]["loss"] for mode in ("True", "False")}
    del finals
    if not all(out["per_unit_bitwise"].values()):
        raise AssertionError(f"sharded_recipes: per-unit gathering is not the whole-tree step "
                             f"bitwise: {out['per_unit_bitwise']}")

    # (b) ZeRO-offload of each rank's ranges
    off = {}
    for label, chunk in (("monolithic", None), ("chunked_pipelined", MEM_OFFLOAD["chunk_gib"])):
        plugin = FullyShardedDataParallelPlugin(
            sharding_strategy="FULL_SHARD", cpu_offload=True, offload_params=True,
            host_update_chunk_gib=chunk, host_update_pipeline=True)
        mesh, ranks = _recipe_world(torch, dp4, start, replicas, plugin=plugin, device=device)
        metrics, ms = _recipe_step(torch, mesh, dp4, ranks, ids)
        rank_rep = []
        for acc, state, _ in ranks:
            n_range = sum(p.numel() for p in state.params.values())
            want = offload_transfer_accounting(n_range, optimizer=RECIPES_6I["optimizer"])
            log_ = acc.offload_log
            rank_rep.append({k: log_[k] for k in ("d2h_bytes", "h2d_bytes", "groups",
                                                  "host_update_ms", "host_wait_ms", "d2h_ms")
                             if k in log_} | {
                "predicted_d2h": want["d2h_bytes"], "predicted_h2d": want["h2d_bytes"],
                "pinned": all(p.is_pinned() for p in state.params.values())
                and all(t.is_pinned() for t in opt_tensors(state))})
        off[label] = {"step_ms": ms, "loss": metrics[0]["loss"].item(), "ranks": rank_rep}
        if label == "monolithic":
            off[label]["bitwise_resident"] = all(
                all_equal(torch, _rank_snapshot(r[1]), want)
                for r, want in zip(ranks, first_resident))
        log("sharded_recipes (b)", label, json.dumps(off[label]))
        del ranks, mesh
        torch.cuda.empty_cache()
    out["offload"] = off
    bad = [r for rep in off.values() for r in rep["ranks"]
           if r["d2h_bytes"] != r["predicted_d2h"] or r["h2d_bytes"] != r["predicted_h2d"]
           or not r["pinned"]]
    if bad or not off["monolithic"]["bitwise_resident"] or \
            off["chunked_pipelined"]["loss"] != mem["True"]["loss"][0]:
        raise AssertionError(f"sharded_recipes offload: {off}")
    del first_resident

    # (c) fp8 across ranks, each product held to plain
    fp8 = {}
    checked = {"products": 0, "worst": 0.0, "worst_of_row_max": 0.0,
               "products_over_row_max_rtol": 0}
    real = prec.fp8_mm

    def held_mm(a, b, descale, out_dtype):
        """The product in f32 beside the plain f32 one on the same codes;
        the step goes on with the product it asked for.  Each row's error
        is held to ``FP8_MM_RTOL`` of the row's largest sum of |terms|
        (sum_k |a_ik| |b_kj| / descale): a gradient product whose row sum
        cancels leaves the fp8 tensor cores' partial sums as large as the
        terms (fp8_gemm_checks' random operands never do), so its error against
        the row's largest |value| is reported beside it."""
        got = real(a, b, descale, torch.float32)
        ref = prec.fp8_mm_plain(a, b, descale, torch.float32)
        err = (got - ref).abs().amax(dim=1)
        terms = (a.float().abs() @ b.float().abs()) / descale.float()
        over_terms = (err / terms.amax(dim=1).clamp(min=1e-30)).max().item()
        over_row = (err / ref.abs().amax(dim=1).clamp(min=1e-30)).max().item()
        checked["products"] += 1
        checked["worst"] = max(checked["worst"], over_terms)
        checked["worst_of_row_max"] = max(checked["worst_of_row_max"], over_row)
        checked["products_over_row_max_rtol"] += int(over_row > FP8_MM_RTOL)
        return real(a, b, descale, out_dtype)

    for label, pcfg in (("dp4", dp4), ("tp2_dp2", ParallelismConfig(tp_size=2, dp_shard_size=2))):
        rep = {}
        for mp in ("bf16", "fp8"):
            plugin = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD")
            mesh, ranks = _recipe_world(torch, pcfg, start, replicas, plugin=plugin,
                                        mixed_precision=mp, device=device)
            if mp == "fp8" and ranks[0][0].mixed_precision != "fp8":
                raise AssertionError(f"fp8 resolved to {ranks[0][0].mixed_precision}")
            reset_counts()
            real.launches = 0
            metrics, ms = _recipe_step(torch, mesh, pcfg, ranks, ids)
            rep[mp] = {"step_ms": ms, "tokens_per_s": world * TRAIN["seq"] / (ms / 1e3),
                       "loss": metrics[0]["loss"].item(),
                       "launches": {n: fa_launches(n) for n in FLASH_REPLACES},
                       "fp8_products": real.launches}
            PATH_LAUNCHES[f"sharded_recipes_{mp}_{label}"] = rep[mp]["launches"]
            if mp == "fp8":
                metas = [r[1].fp8_state for r in ranks]
                rep["metas_equal_on_every_rank"] = all(
                    torch.equal(m[k].amax_history, metas[0][k].amax_history)
                    and torch.equal(m[k].scale, metas[0][k].scale) for m in metas for k in m)
                rep["metas"] = len(metas[0])
                # the delayed-scaling products call ops/fp8's name
                fp8_mod.fp8_mm = held_mm
                try:
                    _recipe_step(torch, mesh, pcfg, ranks, ids)
                finally:
                    fp8_mod.fp8_mm = real
            del ranks, mesh
            torch.cuda.empty_cache()
        rep["fp8_over_bf16_tokens"] = rep["fp8"]["tokens_per_s"] / rep["bf16"]["tokens_per_s"]
        fp8[label] = rep
        log("sharded_recipes (c)", label, json.dumps(rep))
    out["fp8"] = fp8
    out["fp8_products_checked"] = checked
    if not all(r["metas_equal_on_every_rank"] for r in fp8.values()) or \
            checked["worst"] > FP8_MM_RTOL or not checked["products"]:
        raise AssertionError(f"sharded_recipes fp8: {fp8} {checked}")
    log("sharded_recipes", json.dumps({k: v for k, v in out.items()
                                        if k not in ("per_unit", "offload", "fp8")}))
    return out


# 6j. tensor-parallel serving and generation: the 600m serve over virtual
# tp worlds on one card (every rank a thread of this process, bound to its
# tp slices by bind_tp_slices), the collective matmul off.  The serves keep
# the trace's 32-128 new tokens on its first 2 requests, cut for the time
# limit (the ranks run one at a time, and a tp 2 / tp 4 tick took 3x / 8x
# the one-process tick's host time; a checked tick, every launch held to
# plain, 0.3-0.6 s; with 8 / 2 / 2 / 4 requests a bare call took 1,156 s).
# Each checked rerun serves them until one of them wrote into a page past
# its prompt's
TP_SERVE = dict(tps=(2, 4), requests=2, gen_batch=4, gen_prompt=128, gen_new=32, beams=4,
                beam_new=8, checked_gen_new=4, scan_batch=4)


def tp_world(tp: int):
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    return VirtualMesh(*_layout(tp=tp)), ParallelismConfig(tp_size=tp)


def tp_bind(torch, model, tp: int) -> tuple:
    """``(mesh, pcfg, ranks, bytes report)``: every rank's module bound to
    its tp slices, and the bytes each rank holds against
    ``plan_bytes_per_device`` of the whole state under the rank's plan."""
    from accelerate_tpu_torch.parallel.sharding import (
        bind_tp_slices, held_bytes, plan_bytes_per_device,
    )

    mesh, pcfg = tp_world(tp)
    ranks = mesh.run(lambda r: bind_tp_slices(model), pcfg)
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in model.state_dict().items()}
    held = [held_bytes(m) for m in ranks]
    planned = plan_bytes_per_device(shapes, ranks[0].tp_plan, mesh)
    if any(h != planned for h in held):
        raise AssertionError(f"tp {tp}: ranks hold {held} B, the plan {planned} B")
    return mesh, pcfg, ranks, {"rank_weight_bytes": held[0], "plan_bytes_per_device": planned,
                               "one_process_weight_bytes": held_bytes(model)}


def tp_engines(torch, mesh, pcfg, ranks, kv_dtype="bf16", stores=None):
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin

    def make(r):
        eng = ServingEngine(ranks[r], ServingPlugin(**PLUGIN, kv_dtype=kv_dtype),
                            GenerationConfig(max_new_tokens=MAX_NEW), device=ranks[r].device,
                            adapters=stores[r] if stores else None)
        eng.warmup()
        return eng

    return mesh.run(make, pcfg)


def pool_bytes_of(engine) -> int:
    return sum(t.numel() * t.element_size() for layer in engine.cache["layers"]
               for t in layer.values())


def tp_near_tie(torch, model, mesh, pcfg, ranks, prompt, ref: list, got: list,
                label: str, adapters=None, tenant: int = 0) -> dict:
    """Where a tp run's tokens first differ from the one-process run's, at
    ``i``: the reference sequence up to its token ``i`` teacher-forced
    through the one-process model and the tp world (uncached forwards;
    with ``adapters``, the one-process store and the ranks' stores,
    through ``tenant``'s adapter, pinned for the run); near-tie iff the two
    tokens' logit gap (one process) is within the largest |logit
    difference| between the two at that position."""
    i = next(j for j, (a, b) in enumerate(zip(ref, got)) if a != b)
    ids = torch.tensor(list(prompt) + list(ref[:i]), device=model.device)[None]
    stores = [adapters[0]] + list(adapters[1]) if adapters and tenant else []
    kw = [dict(adapter_ids=torch.tensor([st.pin(tenant)[0]], device=model.device),
               lora=st.pool) for st in stores] or [{}] * (1 + len(ranks))
    with torch.inference_mode():
        one = model(ids, **kw[0])[0, -1]
        tp = mesh.run(lambda r: ranks[r](ids, **kw[1 + r]), pcfg)[0][0, -1]
    for st in stores:
        st.unpin(tenant)
    gap = abs(one[ref[i]] - one[got[i]]).item()
    dlogit = (one - tp).abs().max().item()
    div = {"index": i, "reference_token": ref[i], "token": got[i], "logit_gap": gap,
           "max_abs_dlogit_one_process_vs_tp": dlogit, "near_tie": gap <= dlogit}
    log(f"tp_serving token rule {label}", json.dumps(div))
    if not div["near_tie"]:
        raise AssertionError(f"{label}: tokens diverge at {i} without a near-tie: {div}")
    return div


def tp_token_rule(torch, model, mesh, pcfg, ranks, trace, ref: dict, got: list,
                  label: str, adapters=None) -> dict:
    """Every rank's tokens equal rank 0's; rank 0's equal the one-process
    engine's or first differ at a near-tie (:func:`tp_near_tie`;
    ``adapters``: the one-process store and the ranks')."""
    for r, res in enumerate(got):
        if res != got[0]:
            raise AssertionError(f"{label}: rank {r}'s tokens differ from rank 0's")
    equal, divergences = 0, []
    for req in trace:
        a, b = list(ref[req.uid]), list(got[0][req.uid])
        if a == b:
            equal += 1
            continue
        if len(a) != len(b) and a[:len(b)] == b[:len(a)]:
            raise AssertionError(f"{label} request {req.uid}: {len(b)} tokens, reference {len(a)}")
        divergences.append({"uid": req.uid, **tp_near_tie(
            torch, model, mesh, pcfg, ranks, req.prompt, a, b, f"{label} {req.uid}",
            adapters, req.adapter_id)})
    return {"requests": len(trace), "equal": equal, "divergences": divergences}


def tp_serve_timed(torch, mesh, pcfg, engines, trace) -> tuple:
    """Every rank's engine replays ``trace`` with the launch counts zeroed
    first; rank 0's report (its wall spans the world's, the ranks taking
    turns), every rank's results and launches."""
    from accelerate_tpu_torch import replay

    reset_counts()
    reports = mesh.run(lambda r: replay(engines[r], trace), pcfg)
    sync(torch)
    launches = launch_counts()
    return reports[0], [dict(e.results) for e in engines], launches


def past_a_page(trace) -> list:
    """``trace``'s requests with their new tokens cut to the fewest with
    which one of them writes into a page past its prompt's (decode step
    ``k`` writes position ``prompt_len + k - 1``)."""
    page = PLUGIN["page_size"]
    return capped(trace, min(-(-r.prompt_len // page) * page - r.prompt_len + 2 for r in trace))


def tp_checked(torch, mesh, pcfg, ranks, trace, kv_dtype="bf16", stores=None, required=()):
    """The trace (until one of its requests wrote into a page past its
    prompt's, :func:`past_a_page`) on fresh engines with every kernel launch
    held against its plain version; after every tick the serving contract
    on every rank, and each rank's block tables and event log equal to rank
    0's.  Returns each kernel's worst readings and the W8A16 routes taken
    (dense shape and rows -> route)."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    engines = tp_engines(torch, mesh, pcfg, ranks, kv_dtype, stores)
    readings: dict = {}
    routes: dict = {}
    route = qmm._route
    tables: list = [[] for _ in engines]

    def spy(m, qt, wholef):
        got = route(m, qt, wholef)
        routes[f"{qt.shape[0]}x{qt.shape[1]} m={m}"] = got
        return got

    def on_tick(r):
        def check(eng):
            hold_contract(eng, f"rank {r} ")
            tables[r].append((len(eng.sched.events), eng.cache["block_tables"].cpu()))
        return check

    qmm._route = spy
    try:
        with checked_kernels(torch, llama_mod, fa, qmm, readings):
            mesh.run(lambda r: drive(engines[r], past_a_page(trace), on_tick(r)), pcfg)
    finally:
        qmm._route = route
    for r, eng in enumerate(engines):
        if eng.sched.events != engines[0].sched.events or eng.results != engines[0].results:
            raise AssertionError(f"rank {r}: event log or tokens differ from rank 0's")
        if len(tables[r]) != len(tables[0]) or any(
                a[0] != b[0] or not torch.equal(a[1], b[1]) for a, b in zip(tables[r], tables[0])):
            raise AssertionError(f"rank {r}: block tables differ from rank 0's at a tick")
    rep = worst_readings(readings, required)
    rep["invariants_checked_ticks"] = len(tables[0])
    return rep, routes


def tp_serve_case(torch, label: str, model, trace, tp: int = 2, kv_dtype="bf16",
                  lora: bool = False) -> dict:
    """One tp serve of (a)-(c): ``trace`` on the one-process engine, then
    on every rank of a tp world (with ``lora``, 8-tenant stores, every
    rank's swapping as the one-process store): the launches as the path
    says, a rank's KV pool ``kv_heads / Hkv`` of the one-process pool (1 /
    tp where tp divides them), the token rule, TTFT and tokens/s beside
    the one-process serve's, then the checked rerun."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    stamps = {"start": time.perf_counter()}
    one_store = lora_store(torch, model) if lora else None
    one_engine, one_report, _, _ = serve_once(torch, model, trace, kv_dtype, adapters=one_store)
    stamps["one_process"] = time.perf_counter()
    mesh, pcfg, ranks, weights = tp_bind(torch, model, tp)
    stores = mesh.run(lambda r: lora_store(torch, ranks[r]), pcfg) if lora else None
    engines = tp_engines(torch, mesh, pcfg, ranks, kv_dtype, stores)
    report, results, launches = tp_serve_timed(torch, mesh, pcfg, engines, trace)
    stamps["bind_and_serve"] = time.perf_counter()
    PATH_LAUNCHES[f"tp_serving_{label}"] = launches
    m = engines[0].metrics
    quant = "" if kv_dtype == "bf16" else "_quant"
    # launches a decode and a prefill step: one per layer and rank, #11 on
    # the 7 denses of a layer (each rank's whole call or its row slice's),
    # #10 on the targeted denses of a decode step
    decode = {f"paged_decode_attention{quant}": tp * layers}
    prefill = {f"paged_multitoken_attention{quant}": tp * layers}
    required = ["paged_decode_attention", "paged_multitoken_attention"]
    if model.model.layers[0].mlp.down_proj.quantized is not None:
        decode["quantized_matmul_tiled"] = prefill["quantized_matmul_tiled"] = tp * 7 * layers
        required.append("quantized_matmul_tiled")
    if lora:
        decode["bgmv_apply"] = tp * len(LORA["targets"]) * layers
        required.append("bgmv_apply")
    want = {k: decode.get(k, 0) * m["decode_steps"] + prefill.get(k, 0) * m["prefill_steps"]
            for k in {**decode, **prefill}}
    if lora:
        for eng in engines:
            if (eng.adapters.swaps, eng.adapters.hits) != (one_engine.adapters.swaps,
                                                           one_engine.adapters.hits):
                raise AssertionError(f"{label}: a rank's adapter store decided otherwise than "
                                     "the one-process store")
    expect_launches(launches, want)
    hkv, one_pool = cfg.num_key_value_heads, pool_bytes_of(one_engine)
    pools = [pool_bytes_of(e) for e in engines]
    want_pool = one_pool * engines[0].kv_heads // hkv
    if any(p != want_pool for p in pools) or (hkv % tp == 0 and want_pool * tp != one_pool):
        raise AssertionError(f"{label}: rank pools {pools} B, one process {one_pool} B")
    tokens = tp_token_rule(torch, model, mesh, pcfg, ranks, trace, one_engine.results, results,
                           label, adapters=(one_engine.adapters, stores) if lora else None)
    stamps["token_rule"] = time.perf_counter()
    fresh = mesh.run(lambda r: lora_store(torch, ranks[r]), pcfg) if lora else None
    checked, routes = tp_checked(torch, mesh, pcfg, ranks, trace, kv_dtype, fresh, required)
    stamps["checked"] = time.perf_counter()
    timing = ("tokens_per_sec", "ttft_p50_ms", "p50_token_latency_ms", "wall_s")
    rep = {"requests": len(trace), "new_tokens": [r.max_new_tokens for r in trace],
           "rank_heads": [cfg.num_attention_heads // tp, engines[0].kv_heads],
           "rank_pool_bytes": pools[0], "one_process_pool_bytes": one_pool, **weights,
           "launches": launches, "decode_launches_per_tick": decode,
           "tokens": tokens, "in_path": checked,
           **{k: report[k] for k in timing + ("p99_token_latency_ms",)},
           "one_process": {k: one_report[k] for k in timing},
           "tokens_per_sec_over_one_process": report["tokens_per_sec"]
           / one_report["tokens_per_sec"],
           "seconds": {k: stamps[k] - t for (_, t), k in zip(stamps.items(), list(stamps)[1:])}}
    if quant or "quantized_matmul_tiled" in want:
        rep["qmm_routes"] = routes
        log(f"tp_serving {label} W8A16 routes (rank's dense H x F, rows -> route):",
            json.dumps(routes))
    if lora:
        rep["adapter_swaps"] = one_engine.adapters.swaps
    log(f"tp_serving {label}:", json.dumps(rep))
    return rep


def tp_generation_case(torch, card: str, label: str, model) -> dict:
    """(d) ``generate`` (B 4 x prompt 128, 32 new tokens) and
    ``beam_search`` (4 beams) at tp 2 against the one-process calls."""
    from accelerate_tpu_torch import GenerationConfig, beam_search, generate

    cfg = model.config
    b, t = TP_SERVE["gen_batch"], TP_SERVE["gen_prompt"]
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (b, t))).to(
        model.device)
    gc = GenerationConfig(max_new_tokens=TP_SERVE["gen_new"])
    bc = GenerationConfig(max_new_tokens=TP_SERVE["beam_new"])
    ref = generate(model, ids, gc)
    ref_beam = beam_search(model, ids, bc, num_beams=TP_SERVE["beams"])
    mesh, pcfg, ranks, weights = tp_bind(torch, model, 2)
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    got = mesh.run(lambda r: generate(ranks[r], ids, gc), pcfg)
    sync(torch)
    gen_s = time.perf_counter() - t0
    launches = launch_counts()
    PATH_LAUNCHES[f"tp_serving_generate_{label}_tp2"] = launches
    reset_counts()
    beams = mesh.run(lambda r: beam_search(ranks[r], ids, bc, num_beams=TP_SERVE["beams"]), pcfg)
    PATH_LAUNCHES[f"tp_serving_beam_{label}_tp2"] = launch_counts()
    for r in range(2):
        if not (torch.equal(got[r], got[0]) and torch.equal(beams[r], beams[0])):
            raise AssertionError(f"generate {label}: rank {r}'s tokens differ from rank 0's")
    rows = []
    for i in range(b):
        a, g = ref[i].tolist(), got[0][i].tolist()
        rows.append("equal" if a == g else tp_near_tie(torch, model, mesh, pcfg, ranks,
                                                        ids[i].tolist(), a, g,
                                                        f"generate {label} row {i}"))

    def score(tokens):
        seq = torch.cat([ids.long(), tokens.long()], dim=1)
        with torch.inference_mode():
            logp = torch.log_softmax(model(seq).float(), dim=-1)[:, t - 1:-1]
        return (logp.gather(-1, tokens.long()[..., None])[..., 0].sum(-1)
                / tokens.shape[1]).tolist()

    beam_equal = torch.equal(beams[0], ref_beam)
    beam_rep = {"equal": beam_equal}
    if not beam_equal:
        tp_score, one_score = score(beams[0]), score(ref_beam)
        beam_rep.update(tp_score_per_token=tp_score, one_process_score_per_token=one_score)
        if any(a < o - BEAM_SCORE_TOL for a, o in zip(tp_score, one_score)):
            raise AssertionError(f"beam {label}: tp beams {tp_score} below the one-process "
                                 f"beams {one_score}")
    if not all(torch.isfinite(x).all() for x in (got[0].float(), beams[0].float())):
        raise AssertionError(f"generate {label}: non-finite tokens")
    if label == "int8":
        need = {"quantized_matmul_tiled", "quantized_matmul_wholef"}
    else:
        need = set()
    missing = [n for n in need if not launches.get(n)]
    if missing:
        raise AssertionError(f"generate {label}: {missing} never launched")
    rep = {"batch": b, "prompt": t, "new": TP_SERVE["gen_new"], **weights,
           "tokens_per_s": b * TP_SERVE["gen_new"] / gen_s, "rows": rows, "beam": beam_rep,
           "launches": launches}
    if need:
        # the checked rerun: every W8A16 launch held to its plain version
        import accelerate_tpu_torch.models.llama as llama_mod
        from accelerate_tpu_torch.ops import flash_attention as fa
        from accelerate_tpu_torch.ops import quantized_matmul as qmm

        readings: dict = {}
        checked_gc = GenerationConfig(max_new_tokens=TP_SERVE["checked_gen_new"])
        with checked_kernels(torch, llama_mod, fa, qmm, readings):
            again = mesh.run(lambda r: generate(ranks[r], ids, checked_gc), pcfg)
        if any(not torch.equal(a, again[0]) for a in again):
            raise AssertionError(f"generate {label}: the ranks' checked tokens differ")
        rep["in_path"] = worst_readings(readings, sorted(need))
    log(f"tp_serving (d) generation {label} tp 2:", json.dumps(rep))
    return rep


def tp_scan_case(torch, fa, card: str, device: str) -> dict:
    """(e) one training step of the scanned stack at 4 x 2048 under tp 2
    against the one-process scanned step (the batch-2 rule), then a
    checked rerun holding every launch of #1-#3 to its plain version."""
    import dataclasses

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, make_llama_loss_fn
    from accelerate_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, make_sharding_plan, tp_shard, tp_split_dim,
    )
    from accelerate_tpu_torch.parallel.virtual import module_replica

    tp = 2
    cfg = dataclasses.replace(LlamaConfig(**MODEL, dtype=torch.bfloat16), scan_layers=True)
    model = LlamaForCausalLM(cfg, device=device, seed=5)
    params = {n: p.detach().to(torch.bfloat16) for n, p in model.named_parameters()}
    names = list(params)
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    batch = token_batch(torch, cfg.vocab_size, TP_SERVE["scan_batch"], device)
    mesh, pcfg = tp_world(tp)
    plan = make_sharding_plan(params, mesh, pcfg, None, TRANSFORMER_TP_RULES)
    dims = {n: tp_split_dim(plan[n]) for n in names}
    replicas = [module_replica(model) for _ in range(tp)]
    rank_loss = [make_llama_loss_fn(m, fused_vocab_chunks=TRAIN["ce_chunks"]) for m in replicas]

    def unsharded():
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = loss_fn(leaves, batch).float()
        return loss, list(torch.autograd.grad(loss, list(leaves.values())))

    def sharded():
        shards = [{n: tp_shard(params[n], dims[n], tp, r).detach().requires_grad_()
                   for n in names} for r in range(tp)]
        losses = mesh.run(lambda r: rank_loss[r](shards[r], batch).float(), pcfg)
        flat = torch.autograd.grad(losses, [s[n] for s in shards for n in names])
        by_rank = [flat[r * len(names):(r + 1) * len(names)] for r in range(tp)]
        return losses[0], [torch.cat([by_rank[r][i] for r in range(tp)], dim=dims[n])
                           if dims[n] is not None else by_rank[0][i]
                           for i, n in enumerate(names)]

    ref = unsharded()
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    got = sharded()
    sync(torch)
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = {n: fa._WRAPPERS[n].launches for n in FLASH_REPLACES}
    PATH_LAUNCHES["tp_serving_scan_tp2"] = launch_counts()
    want = tp * cfg.num_hidden_layers
    if any(c != want for c in counts.values()):
        raise AssertionError(f"scanned tp 2: launches {counts}, want {want} each")
    rep = grads_against(torch, "scanned tp 2", names, got, ref)
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        sharded()
    rep.update(launches=counts, step_ms=step_ms, in_path=worst_of(readings, {
        n: want for n in FLASH_REPLACES}), plan_dims={
        "q_proj": dims["model.layers_scan.block.self_attn.q_proj.weight"],
        "o_proj": dims["model.layers_scan.block.self_attn.o_proj.weight"]})
    log("tp_serving (e) scanned stack tp 2:", json.dumps(rep))
    del ref, got, replicas, params, model
    return rep


def tp_serving_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """6j: tensor-parallel serving and generation (module doc, 6j)."""
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, QuantizationConfig
    from accelerate_tpu_torch import quantize_model_, synthesize_trace

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    trace = synthesize_trace(0, N_REQUESTS, **TRACE)[:TP_SERVE["requests"]]
    out = {"card": card}
    stamps = {}
    t = time.perf_counter()
    out["bf16"] = {f"tp{tp}": tp_serve_case(torch, f"bf16_tp{tp}", model, trace, tp)
                   for tp in TP_SERVE["tps"]}
    stamps["a_bf16"] = time.perf_counter() - t
    t = time.perf_counter()
    qmodel = quantize_model_(LlamaForCausalLM(cfg, device=device, seed=0),
                             QuantizationConfig(load_in_8bit=True))
    out["int8"] = tp_serve_case(torch, "int8_tp2", qmodel, trace, kv_dtype=QUANT_KV)
    stamps["b_int8"] = time.perf_counter() - t
    t = time.perf_counter()
    out["lora"] = tp_serve_case(torch, "lora_tp2", model, synthesize_trace(
        0, N_REQUESTS, **TRACE, adapters=LORA_TENANTS)[:TP_SERVE["requests"]], lora=True)
    stamps["c_lora"] = time.perf_counter() - t
    t = time.perf_counter()
    out["generate_bf16"] = tp_generation_case(torch, card, "bf16", model)
    out["generate_int8"] = tp_generation_case(torch, card, "int8", qmodel)
    stamps["d_generation"] = time.perf_counter() - t
    del qmodel, model
    sync(torch)
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["scan"] = tp_scan_case(torch, fa, card, device)
    stamps["e_scan"] = time.perf_counter() - t
    out["seconds"] = stamps
    log("tp_serving seconds by case:", json.dumps(stamps))
    log(f"tp serving on {card}:", json.dumps({
        f"{case} {tp}": {k: rep[k] for k in ("tokens_per_sec", "ttft_p50_ms", "rank_pool_bytes",
                                              "one_process_pool_bytes", "one_process")}
        for case, reps in (("bf16", out["bf16"]), ("int8", {"tp2": out["int8"]}),
                           ("lora", {"tp2": out["lora"]})) for tp, rep in reps.items()}))
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_in_path(out: dict) -> dict:
    """Each kernel's checked readings in the tp cases, by case."""
    rename = {"int8": {"paged_decode_attention": "paged_decode_attention_quant",
                       "paged_multitoken_attention": "paged_multitoken_attention_quant"}}
    cases = {"bf16_tp2": out["bf16"]["tp2"]["in_path"], "bf16_tp4": out["bf16"]["tp4"]["in_path"],
             "int8": out["int8"]["in_path"], "lora": out["lora"]["in_path"],
             "generate_int8": out["generate_int8"]["in_path"], "scan": out["scan"]["in_path"]}
    got: dict = {}
    for case, readings in cases.items():
        for name, rep in readings.items():
            if isinstance(rep, dict):
                got.setdefault(rename.get(case, {}).get(name, name), {})[case] = rep
    return got


# the phases --only selects, in the order the bare call runs them
PHASES = ("kernels", "serving", "training", "train_resume", "memory_recipes", "lora_train",
          "examples", "parallel", "moe", "fleet_fabric", "sharded_ckpt",
          "sharded_recipes", "tp_serving")



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", type=Path, default=None, metavar="DIR",
                        help="a checkout of an earlier commit: its flash_attention.cu, "
                             "paged_attention.cu (where it has one, else paged_decode.cu), "
                             "quantized_matmul.cu and lora.cu are built, and its #2 / #3, "
                             "#4 / #5 (where paged_attention.cu has them), #8 / #9, #12 and "
                             "#10 (with the select's three launches) are held to their plain "
                             "versions and timed beside the new ones (before_ms)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the train_resume phase's token rows and data order")
    parser.add_argument("--only", type=lambda v: [x.strip() for x in v.split(",") if x.strip()],
                        default=None, metavar="PHASE[,PHASE]",
                        help="run only these phases (the bare call runs them all), of: "
                             + ", ".join(PHASES) + "; train_resume brings training with it. "
                             "The kernels line then lists the kernels the run reached")
    args = parser.parse_args()
    only = set(args.only) if args.only is not None else set(PHASES)
    unknown = only - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; phases: {', '.join(PHASES)}")
    if "train_resume" in only:
        only.add("training")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "accelerate_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa

    # the plain versions are the reference: full-f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    before_build = start_before_build(args.before.resolve()) if args.before else None
    libs = _build.build_all(["paged_decode", "paged_prefill", "flash_attention",
                             "quantized_matmul", "lora"])
    if before_build:
        BEFORE.update(before_kernels(torch, before_build, args.before.resolve()))
    log(f"build (parallel nvcc): {time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(lib.name for lib in libs.values())}")
    for name in libs:
        log(f"{name}: nvcc {_build.BUILD_LOG[name]['seconds']:.2f} s")
        log(_build.BUILD_LOG[name]["ptxas"].strip())
    SASS.update(kernel_sass(libs["flash_attention"], _build.BUILD_LOG["flash_attention"]["ptxas"]))
    log("flash #2 / #3 (registers, spilled bytes, HGMMA, WARPGROUP.DEPBAR per head dim):",
        json.dumps(SASS))
    decode, fused = decode_ptxas(_build.BUILD_LOG["paged_decode"]["ptxas"])
    DECODE_PTXAS.update(decode)
    FUSED_PTXAS.update(fused)
    decode_loop_spills(libs["paged_decode"], DECODE_PTXAS, FUSED_PTXAS)
    log("paged decode #4 / #5 (registers, spilled bytes by pages, head dim, rows):",
        json.dumps(DECODE_PTXAS))
    log("fused LoRA decode #8 / #9 (registers, spilled bytes by pages, head dim, rows):",
        json.dumps(FUSED_PTXAS))
    WHOLEF_PTXAS.update(kernel_ptxas(
        _build.BUILD_LOG["quantized_matmul"]["ptxas"], "qmm_wholef_kernel",
        lambda name: "M " + re.search(r"qmm_wholef_kernelILi(\d+)E", name).group(1)))
    log("W8A16 #12 (registers, spilled bytes by rows of x):", json.dumps(WHOLEF_PTXAS))
    LORA_PTXAS.update(kernel_ptxas(
        _build.BUILD_LOG["lora"]["ptxas"], "bgmv_kernel",
        lambda name: "bgmv_apply" if "bgmv_kernelILb1E" in name else "bgmv"))
    log("LoRA #10 (registers, spilled bytes by entry point):", json.dumps(LORA_PTXAS))

    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        log(f"phase {name}: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()

    kernels, serve, quant, gen, lora, train = {}, None, None, None, None, None
    if "kernels" in only:
        kernels = kernel_phases(torch, F, fa)
        phase_done("paged kernels #4-#7")
        kernels.update(qmm_kernel_phases(torch, F))
        phase_done("W8A16 kernels #11, #12")
        kernels.update(flash_kernel_phases(torch, F, fa))
        phase_done("flash kernels #1-#3")
        kernels.update(lora_kernel_phases(torch))
        phase_done("LoRA kernel #10")
    if "serving" in only:
        with torch.inference_mode():
            serve = engine_phase(torch, card)
            phase_done("bf16 serve")
            spec = speculate_phase(torch, card, serve)
            phase_done("speculative serve")
            quant = quant_engine_phase(torch, card, serve)
            phase_done("quantized serve")
            pages_32_phase(torch, quant["model"], card, serve["trace"])
            phase_done("quantized serve over pages of 32")
            prefix = prefix_phase(torch, card, serve, quant["model"])
            phase_done("prefix-cache serve")
            overload = overload_phase(torch, card, serve)
            phase_done("overload serve")
            pairs = disaggregate_phase(torch, card, serve, quant)
            phase_done("disaggregated pair")
            fleet_phase(torch, card, serve, prefix)
            phase_done("fleet")
            big_model_phase(torch, card, serve, quant)
            phase_done("big_model")
            gen = generate_paged_phase(torch, quant.pop("model"), card)
            phase_done("generate_paged")
            generate_paged_phase(torch, serve["model"], card, kv_dtype="bf16")
            phase_done("generate_paged over bf16 pages")
            lora = lora_engine_phase(torch, card, serve)
            phase_done("LoRA serve")
            kernels.update(fused_op_phase(torch, F, fa, serve.pop("model"), lora["trace"]))
            phase_done("fused LoRA decode #8, #9")
        del lora["store"]
        torch.cuda.empty_cache()
        log("speculate, prefix, overload and pair checked launches:", json.dumps({
            "speculate": spec["in_path"], "speculate_draft": spec["draft_in_path"],
            "prefix": prefix["in_path"], "prefix_int8": prefix["quant_in_path"],
            "overload": overload["in_path"],
            **{label: rep["in_path"] for label, rep in pairs.items()}}))
    if "training" in only:
        train = training_phase(torch, fa, card)
        phase_done("training")
    if "train_resume" in only:
        resumed = train_resume_phase(torch, fa, card, args.seed, train["report"]["step_ms"],
                                     train["report"]["params"])
        PATH_LAUNCHES["train_resume"] = resumed["launches"]
        ladder = recovery_ladder(torch, fa, card)
        PATH_LAUNCHES["train_resume_ladder"] = ladder["launches"]
        phase_done("train_resume")
    if "memory_recipes" in only:
        memory = memory_recipes_phase(torch, F, fa, card)
        for name, rep in memory["fp16"]["kernels_f16"].items():
            if name not in kernels:
                continue
            # the f16 instances' cases and times beside the bf16 instances'
            kernels[name]["cases"] = kernels[name]["cases"] + rep["cases"]
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], rep["max_abs_err"])
            kernels[name]["err_over_limit"] = max(kernels[name]["err_over_limit"],
                                                  rep["err_over_limit"])
            kernels[name]["f16"] = {k: rep[k] for k in ("ms", "bf16_ms", "bound_ms", "bound_by",
                                                        "library_ms", "max_abs_err",
                                                        "err_over_limit")}
        phase_done("memory_recipes")
    if "lora_train" in only:
        lora_train = lora_train_phase(torch, fa, card)
        PATH_LAUNCHES["lora_train"] = lora_train["launches"]
        for name, rep in lora_train["in_path"].items():
            if name not in kernels:
                continue
            # held at the LoRA step's shape on its own operands
            case = f"lora_train_b{LORA_TRAIN['batch']}_t{LORA_TRAIN['seq']}"
            kernels[name]["cases"] = kernels[name]["cases"] + [case]
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], rep["max_abs_err"])
            kernels[name]["err_over_limit"] = max(kernels[name]["err_over_limit"],
                                                  rep["err_over_limit"])
            kernels[name]["lora_train_in_path"] = rep
        phase_done("lora_train")
    if "examples" in only:
        examples_phase(torch, card)
        phase_done("examples")
    if "parallel" in only:
        parallel = parallel_phase(torch, fa, card)
        PATH_LAUNCHES["parallel"] = parallel["launches"]
        PATH_LAUNCHES["parallel_ulysses"] = parallel["ulysses_launches"]
        PATH_LAUNCHES["parallel_tp"] = parallel["tp_launches"]
        PATH_LAUNCHES["parallel_pp"] = parallel["pp_launches"]
        PATH_LAUNCHES["parallel_dcn"] = parallel["dcn_launches"]
        PATH_LAUNCHES["parallel_powersgd"] = parallel["powersgd_launches"]
        phase_done("parallel")
    if "moe" in only:
        moe = moe_phase(torch, fa, card)
        PATH_LAUNCHES["moe"] = moe["launches"]
        PATH_LAUNCHES["moe_ep"] = moe["ep_launches"]
        phase_done("moe")
    if "fleet_fabric" in only:
        fabric = fleet_fabric_phase(torch, card)
        PATH_LAUNCHES["fleet_fabric_prefill"] = fabric["launches"]["prefill"]
        PATH_LAUNCHES["fleet_fabric_decode"] = fabric["launches"]["decode"]
        phase_done("fleet_fabric")
    if "sharded_ckpt" in only:
        sharded = sharded_ckpt_phase(torch, fa, card)
        PATH_LAUNCHES["sharded_ckpt"] = sharded["launches"]
        phase_done("sharded_ckpt")
    if "sharded_recipes" in only:
        sharded_recipes_phase(torch, fa, card)
        phase_done("sharded_recipes")
    if "tp_serving" in only:
        tp_serving = tp_serving_phase(torch, fa, card)
        for name, rep in tp_in_path(tp_serving).items():
            if name in kernels:
                kernels[name]["tp_serving_in_path"] = rep
        phase_done("tp_serving")

    # each kernel's launches on its main path, and its checked calls there
    main_path = {}
    if train is not None:
        main_path.update({name: (train["launches"][name], train["in_path"][name])
                          for name in FLASH_REPLACES})
    if serve is not None:
        quant_in_path = quant["in_path"]
        main_path.update({
            "paged_decode_attention": (serve["decode"],
                                       serve["in_path"]["paged_decode_attention"]),
            "paged_multitoken_attention": (serve["prefill"],
                                           serve["in_path"]["paged_multitoken_attention"]),
            "paged_decode_attention_quant": (quant["launches"]["paged_decode_attention_quant"],
                                             quant_in_path["paged_decode_attention"]),
            "paged_multitoken_attention_quant": (
                quant["launches"]["paged_multitoken_attention_quant"],
                quant_in_path["paged_multitoken_attention"]),
            "quantized_matmul_tiled": (quant["launches"]["quantized_matmul_tiled"],
                                       quant_in_path["quantized_matmul_tiled"]),
            "quantized_matmul_wholef": (gen["launches"]["quantized_matmul_wholef"],
                                        gen["in_path"]["quantized_matmul_wholef"]),
            "bgmv_apply": (lora["launches"]["bgmv_apply"], lora["in_path"]["bgmv_apply"]),
            # no engine calls #8 / #9: their launches are the op phase's
            "fused_bgmv_paged_decode": (kernels["fused_bgmv_paged_decode"]["launches"],
                                        kernels["fused_bgmv_paged_decode"]["in_path"]),
            "fused_bgmv_paged_decode_quant": (
                kernels["fused_bgmv_paged_decode_quant"]["launches"],
                kernels["fused_bgmv_paged_decode_quant"]["in_path"]),
        })
    sources = {"flash": "accelerate_tpu_torch/csrc/flash_attention.cu",
               "paged_multitoken_attention": "accelerate_tpu_torch/csrc/paged_prefill.cu",
               "paged_decode_attention": "accelerate_tpu_torch/csrc/paged_decode.cu",
               "fused": "accelerate_tpu_torch/csrc/paged_decode.cu",
               "quantized_matmul": "accelerate_tpu_torch/csrc/quantized_matmul.cu",
               "bgmv_apply": "accelerate_tpu_torch/csrc/lora.cu"}
    entries = []
    for name, (count, in_path) in main_path.items():
        if name not in kernels:
            continue
        rep = kernels[name]
        source = sources[next(k for k in sources if name.startswith(k))]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": (FLASH_REPLACES.get(name) or REPLACES.get(name)
                                     or LORA_REPLACES[name]),
                        "launches": count,
                        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
                        "err_over_limit": rep["err_over_limit"], "in_path": in_path,
                        # the launches of the later paths, each counted from
                        # 0 over its own run
                        "paths": {path: counts[name] for path, counts in PATH_LAUNCHES.items()
                                  if counts.get(name)},
                        "card": card, "shape": rep["shape"],
                        **{k: rep[k] for k in ("before_ms", "bitwise", "ptxas", "cases",
                                               "delta_ms", "four_launch_ms", "composed_ms",
                                               "f16", "lora_train_in_path",
                                               "tp_serving_in_path")
                           if k in rep}})
    if len(entries) != 12 and args.only is None:
        raise AssertionError(f"the kernels line holds {len(entries)} kernels, not 12")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
