#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the CUDA kernels of K1-K7 from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths through their own entry points: the
paper's NN1 (784-1000-500-10) trained with Adam, on one device and as a
period program on an 8-device ring, that program again losing two of its
devices and resuming from a checkpoint on the six left, Zamba2-1.2B,
qwen3-14b, qwen2-moe-a2.7b and mamba2-2.7b served at full width in bf16,
and seamless-m4t-large-v2 (full width) and qwen2-vl-72b (full width, cut
in depth) through their prefill and decode steps, granite-3-2b,
Zamba2-1.2B, mamba2-2.7b, granite-moe-1b-a400m, seamless-m4t-large-v2
and qwen2-vl-72b (cut in depth) trained at full width by the LM train
step (attention, the SSD and the loss through their kernels and backward
kernels), Zamba2-1.2B served on a ring of 8 logical devices losing 2
under the Lemma-1 autoscaler and prefilled past its attention window,
granite-3-2b
trained by the LM training driver through a crash and a resume, and NN1
and NN5 trained in bf16.  Phases, each
printing its own lines; any failure raises and the script exits non-zero
without a result line:

  1. device   a CUDA card is required; its name and power limit; TF32 off
  2. build    the extension, with ptxas's per-kernel resource report
              (registers, shared memory and spills of the redesigned
              kernels, K1, K2, K3 (both kernels of each), bf16 K6 and K7,
              the six kernels of K6's backward and the three of K7's,
              whose spills must be 0) and the count of HGMMA, HMMA and
              FFMA instructions in each kernel's SASS (cuobjdump); K1's
              and K2's bf16-weight kernels, K3's bf16-x kernel, the bf16
              K6 kernel and its backward's fused kernel and the bf16 K7
              kernel and its backward's must emit HGMMA, and ptxas must
              not serialize their wgmma; the fp32 backwards' fused kernels
              (3xTF32 on mma.sync) must emit HMMA; the fused K6 backward
              must be launched with the 168 registers its setmaxnreg
              hand-over assumes
  3. kernels  each FCNN kernel against its plain PyTorch version on the
              card, at the NN1 and NN5 shapes and at edge shapes, with
              times of the kernel, the plain version and one PyTorch
              library call; K1 and K2 (cluster split-K) run twice must
              give bit-identical outputs; each timed K1, K2 and K3 row
              prints what its host plan picked ((split, slice), or K3's dW
              tile height) and the device time of every other choice, each
              held to the plain version; K4/K5 (softmax_xent) in fp32 and
              bf16 at NN1 (64, 10), NN5 (128, 10) and the edges (1, 10)
              and (37, 300), and at LM loss shapes (2048, 49408) fp32 and
              bf16, (4096, 32000), (37, 49408), (2048, 1000), and the
              losses phases 18e and 18f train, (1024, 256256) and (2048,
              152064) fp32, each K4/K5
              row naming the launch its host plan picked (K4: the
              one-block lane kernel, or the rows kernel's warps a row;
              both: 16-byte vectors or not), nll, lse and the batch mean
              within 1e-5, dlogits element-wise within 1e-5 of its size
              (bf16: one bf16 ulp) plus 1e-6 of its row's largest, K4's
              mean run twice bit-identical; then an empty kernel timed the same way (the
              launch floor) and one NN1 step's forward and backward
              captured in a CUDA graph
  4. autograd gradients of the fused ops on NN1 against autograd of the
              plain versions
  5. train    NN1, 300 steps, batch 64, seed 0, through
              ``repro_torch.launch.train_fcnn.train``; accuracy > 0.8 and
              every FCNN kernel launched (launch counters reset just
              before); then a profiled window of 50 steps: device busy
              time per step and the top device operations
  6. nn5      5 steps of NN5 at batch 128, kernel path against plain path
              from the same seed; losses within 1e-4
  7. lm kernels  flash attention (K6) and the SSD intra-chunk kernel (K7)
              against their plain versions at the Zamba2 prefill shapes
              (bf16 and fp32, causal and not, stride-0 B/C; K7 at 1, 4, 8
              and 16 chunks; bf16 within about one bf16 ulp) and at edge
              shapes; K7 at mamba2-2.7b's (16 chunks, 80 heads, N = 128)
              and at N = 72-128 edges; K6 cross-attention (1, 16, Sq, 64)
              over 1024 keys, Sq = 128, 512, 2048, with Sq != Sk edges
              (Sq = 1, 77 over 203, Sq > Sk); K6 at qwen2-vl-72b's
              (1, 64, 2048, 128) on 8 KV heads; K6 with grouped-query
              attention at qwen3-14b's prefill shapes (1, 40, S, 128) on 8 KV heads, S = 512, 1024,
              2048, and at groups of 1, 4 and 5 with S = 1, 100, 300 and
              D = 64, 128; with kernel, plain, SDPA (``enable_gqa``) and
              bound times (K7's bound
              by bytes and by bf16 or TF32 operations apart; each fp32 row
              also the bound its products would have on the CUDA cores);
              each K6 line names the instantiation that ran (tensor-core
              bf16 or 3xTF32 fp32); each timed K7 row, bf16 and fp32,
              prints the heads per block its plan picked and the device
              time of every other choice, each held to the plain version
              and run twice bit-identical; every timed fp32 K6 and K7
              output also against its plain version run in float64, the
              kernel's distance at most 8x the fp32 plain version's
              (``F64_WITNESS``);
              K6 with a sliding causal window at Zamba2's (1, 32, S, 64)
              and qwen3-14b's (1, 40, S, 128) on 8 KV heads, S = 2048 and
              4096, windows 1, 63, 64, 65, 127, 128, 129 and 1000, in bf16
              and fp32, at the same bars (window 1 returns v bit for bit),
              timed beside SDPA with the same boolean mask and the bound
              of the kept pairs only; then K6's backward
              (``flash_attention_bwd``) against its plain version on the
              kernel's own o and lse, bf16 and fp32, at granite-3-2b's
              and Zamba2-1.2B's training shapes, qwen3-14b's (1, 40,
              2048, 128) on 8, seamless's cross-attention (1, 16, 512, 64)
              over 1024 frames, a window of 1000 at 4096 tokens, what
              phases 18d-18f train: granite-moe-1b-a400m's (1, 16, 2048,
              64) on 8, seamless's encoder and cross-attention at its
              train inputs (1, 16, 1024, 64) full and its decoder's causal,
              qwen2-vl-72b's (1, 64, 2048, 128) on 8 (each timed beside
              the plain version, SDPA's backward and the bound, and its
              forward with the lse held to the
              plain version and timed beside it, SDPA's forward and the
              bound) and edges (S = 1, ragged tiles, Sk < a tile, D = 16
              to 128, groups of 1 to 5, windows 1 and 65); repeats
              bit-identical, the forward's o with its lse bit-identical to
              o without it (bars at ``K6_BWD_FP32_RTOL``); then K7's
              backward (``ssd_chunk_bwd``) against its plain version, bf16
              and fp32, at Zamba2-1.2B's and mamba2-2.7b's training SSD
              shapes (16 chunks of 128, 64 and 80 heads, N = 64 and 128,
              one B/C group; timed beside the plain version and the bound;
              in each dtype at every heads-per-block choice of
              ``SSD_BWD_HEADS`` that divides the group's heads, each held to the plain
              version and run twice bit-identical, with the plan's choice
              and the fastest named) and edges (per-head and grouped B/C,
              ragged chunks, Q <= 64, N = 4 to 128, P < 64), each with all
              three cotangents and with one alone; repeats bit-identical
              (bars at ``K7_BWD_FP32_RTOL``); at every timed shape both
              fp32 backwards also against their plain versions run in
              float64: each gradient's distance to that run printed beside
              the fp32 plain version's, the kernel's at most 8x it
              (``F64_WITNESS``)
  8. serve    Zamba2-1.2B, full width, bf16, random weights: 8 requests
              of the ``steady`` preset with 512/1024/2048-token prompts on
              4 slots through ``repro_torch.launch.serve.serve``; every
              request served, K6 and K7 launched 6 and 38 times per
              prefill (counters reset just before); TTFT/TPOT, tok/s and
              peak memory; then a profiled 2048-token prefill, the
              SwiGLU MLP's gate/up GEMMs at that shape with bf16 output
              (the earlier form) and fp32 output (the reference's), and a
              profiled decode step of 4 slots at depth 2048
  9. parity   the full-width model's kernel path against its plain path
              from one set of weights: fp32 prefill logits of a 512-token
              prompt and 8 greedy decode steps within 1e-3 of the largest
              logit; bf16 at 2048 tokens within 4e-2 of the largest
              logit, and the greedy token equal wherever the plain top-2
              gap exceeds twice the logit difference
 10. program  NN1 through its ORRM period program on an 8-device virtual
              ring (``repro_torch.exec``): the program's instruction
              count, degrees and residency peak ratio; K1-K3 at every
              chunk shape of the NN1, NN2 and NN5 programs against their
              plain versions (NN1's timed, and summed over one executor
              step); 300 steps in sharded residency through
              ``repro_torch.launch.train_fcnn.train_program`` to accuracy
              > 0.8 with every off-window slot exactly zero; the kernel
              launches of one executor step (K1 = K3 = 8 + 4 + 2, K2 = 4 +
              2, K4 = K5 = 1), its device busy time and operations; 5 Adam
              steps in sharded and replicated residency bit-identical; and
              the executor's loss and gradients against the single-device
              path for NN1 and NN5 ORRM and NN2 FM/RRM/ORRM
 11. recovery the fault layer (``repro_torch.runtime``) through
              ``repro_torch.launch.elastic_restart``: a crash and restart,
              the replanning oracle at m = 1000/500/100, then NN1 (300
              steps, batch 64, seed 0, phase 10's data and schedule) through
              ``DegradedModeRunner`` on 8 devices, sharded, an async
              checkpoint every 50 steps, under ``seeded_device_loss(0,
              n_lost=2)`` (step 185) and a transient RUN fault failing
              twice at step 10: one replan 8 -> 6 (degrees 2/2/2), resumed
              from the checkpoint of step 149, 2 retries, no kernel
              fallback, the launches per step on each ring equal to its
              program's, accuracy > 0.8; the run matches a from-scratch
              6-device run (losses rtol 1e-4 / atol 1e-6, params rtol 1e-3
              / atol 5e-4), and the replicated run of the same schedule is
              bit-identical; prints the seconds from the fault to the first
              resumed step, the checkpoint's size and save time, and
              ms/step on each ring beside phase 10's; holds K1-K3 at every
              chunk shape of the 6-device program against their plain
              versions; times the recovery over 5 more device losses (a
              40-step run each); then profiles runs of fresh runners on 6
              and on 8 devices with no faults (device operations, host
              ms/step) beside phase 10's executor step
 12. dense    qwen3-14b (GQA 40/8, qk-norm, 40 layers, 14.77 B
              parameters), full width, bf16, random weights drawn layer by
              layer into stacked tensors: 8 requests of the ``steady``
              preset with 512/1024/2048-token prompts on 4 slots through
              ``repro_torch.launch.serve.serve``; every request served, K6
              launched 40 times per prefill (counters reset just before),
              peak memory < 80 GB; TTFT/TPOT, tok/s; then a profiled
              2048-token prefill and a profiled decode step of 4 slots at
              depth 2048
 13. parity   qwen3-14b's kernel path against its plain path: fp32 at full
              width cut to 4 layers, a 512-token prompt and 8 greedy steps
              within 1e-3 of the largest logit; bf16 at full depth, 2048
              tokens, phase 9's logit bar and greedy-token rule
 14. moe      qwen2-moe-a2.7b (60 experts top 4 and 4 shared, QKV bias,
              24 layers), full width, bf16: 4 requests on 4 slots, K6
              launched 24 times per prefill, peak memory < 80 GB; then a
              512-token prefill, kernel path against plain path: the
              expert choices that differ between the paths are counted and
              the greedy-token rule held; with the kernel path's choices
              replayed in the plain path, the logits within phase 9's bar

 15. ssm      mamba2-2.7b (64 attention-free Mamba2 layers, d_model 2560,
              80 heads of 64, state 128, tied embeddings; 2.7 B
              parameters), full width and depth, bf16: 8 requests of
              Zamba2's traffic on 4 slots, K7 launched 64 times and K6 never
              per prefill; a profiled 2048-token prefill and decode step;
              the kernel path against the plain path: fp32 at full depth,
              512 tokens and 8 greedy steps, 1e-3; bf16 at 2048 tokens,
              each layer fed the plain path's input within phase 9's bar,
              the free-running logits within the larger of that bar and
              twice the plain path's own drift with its SSD sum reordered,
              and the greedy-token rule
 16. encdec   seamless-m4t-large-v2 (24 encoder + 24 decoder layers, 16
              heads of 64, d_ff 8192, vocab 256206; 2.0 B parameters), full
              width and depth, bf16, through ``get_model(cfg).prefill`` and
              ``decode_step`` (the serving runner refuses it, as the
              reference's): 1024 random frame embeddings and a 512-token
              prompt, K6 launched 72 times (24 encoder, 24 causal decoder,
              24 cross-attention of 512 queries over 1024 frames), 16
              greedy steps; profiled prefill and decode step; peak memory;
              the kernel path against the plain path: bf16 at 1024/512,
              fp32 at 512/256 with 8 greedy steps
 17. vlm      qwen2-vl-72b (64 heads on 8 KV heads of 128, d_ff 29568,
              M-RoPE 16/24/24), full width cut to 8 of 80 layers (9.5 B
              parameters, 19 GB in bf16): a 32 x 64 image grid's
              embeddings at their M-RoPE positions (2048), K6 launched 8
              times, 8 greedy steps; profiled prefill and decode step; the
              bf16 kernel path against the plain path
 18. train    the LM train step (``repro_torch.launch.steps``):
              granite-3-2b (40 layers, d_model 2048, 32 heads on 8 KV
              heads of 64, d_ff 8192, vocab 49155 padded to 49408, tied;
              2.53 B parameters) at full width and depth, bf16 parameters,
              fp32 AdamW moments, remat, random weights and one batch of
              2 x 2048 seeded token ids in 2 microbatches: 5 steps, every
              loss finite and the last below the first, K4 and K5 launched
              2 times a step, K6 160 (40 layers x 2 microbatches x 2: the
              remat recomputes each forward) and K6's backward 80, K7
              never (counters reset before each step, ``train_launches``),
              no plain version of attention or the SSD reached
              (``PlainSpy``), host
              ms/step, peak memory < 80 GB beside the reckoned, a
              profiled step (device busy, top operations, K4/K5's and K6's
              shares from its rows, and attention, K6 forward + backward
              and its plain version, device time alone multiplied out: an
              estimate); the kernel path
              against the plain path on step 1 from the same weights (loss
              1e-5, gradient norm 1e-2 relative, each gradient leaf 5e-2
              of its norm, the kernel path's peak of requested bytes no
              higher than the plain path's); 3 steps with int8 error feedback, the same checks;
              18b: Zamba2-1.2B at full width and depth, bf16, batch 1 x
              2048, 3 steps (the loss falls, K4/K5 once a step, K6 and its
              backward once a shared-block call, K7 twice a Mamba2 layer
              (remat) and its backward once, no plain version reached),
              step 1 against the plain path (the loss within 1e-4,
              above the plain path's own noise, which is printed beside
              it; the gradient norm and each leaf at the bars above), a
              profiled step with K6's and K7's shares from its rows, and
              the SSD (kernel and plain path) and attention estimated
              from their device time alone;
              18c: mamba2-2.7b (64 Mamba2 layers, 2.7 B parameters) at
              full width and depth, bf16, remat, batch 1 x 2048: the
              dry-run's predicted peak on meta, then 3 AdamW steps (the
              loss finite and falling, K7 128 and its backward 64 a step,
              K4/K5 once, no plain version reached), peak < 80 GB beside
              the prediction, a profiled step with K7's share;
              18d-18f: granite-moe-1b-a400m (24 layers, 32 experts top-8,
              2 x 2048 in 2 microbatches), seamless-m4t-large-v2 (24 + 24
              layers, 2 x (1024 frames + 1024 tokens) in 2) and
              qwen2-vl-72b at full width cut to 2 of 80 layers (1 x 2048
              patch embeddings at M-RoPE positions: an image grid, then
              text), each in bf16 with fp32 moments and full remat from
              seeded weights: phase 22's dry-run of the cell first, 3
              AdamW steps (the loss finite and falling; K4/K5 once a
              microbatch, K6 twice a layer's attention and microbatch and
              its backward once, ``train_launches``; no plain version
              reached), the peak < 80 GB and within 10% of the dry-run's,
              a profiled step (K6's and K4/K5's shares from its rows);
              step 1 against the plain path at phase 18's bars, the
              seamless and qwen2-vl cells' raised to fixed bars, twice the
              largest move of the plain path with the reference's chunked
              attention at its 1024-key chunk (``_flash_fwd_core``'s
              forward and ``_sdpa_chunked_bwd``'s backward) against
              itself over five batches (``TRAIN_FAMILIES``), that witness
              printed each run on the cell's batch, and an fp32 twin (4
              layers; the VLM 1) at 1e-5 for the loss and 1e-4 for each
              leaf.  The MoE's expert choices
              are recorded by (layer, forward or recompute, microbatch)
              and the plain path replays them (``ExpertChoices``); each
              recompute must route bit for bit as its forward; the plain
              path's free-running flip share per layer is printed; step 1
              is taken twice from the same state and the two compared bit
              for bit;
              18g: Zamba2-1.2B in fp32 (weights and activations) at full
              width and depth, remat as configured, batch 1 x 2048: phase
              22's dry-run of the cell first (peak and launches), 2 AdamW steps
              through the fp32 K4/K5, K6, K7 and the backwards of K6 and
              K7 (3xTF32 on the tensor cores), the loss finite and
              falling, launches as ``train_launches`` counts them and as
              the dry-run predicts, no plain version reached, the peak
              within 10% of the dry-run's, a profiled step with K6's and
              K7's shares (with their backwards) of device busy, and step
              1 against the plain path at the fp32 twins' bars (loss
              1e-5, each leaf 1e-4 of its norm)
 19. elastic  Zamba2-1.2B, full width, bf16: 8 requests of the
              ``device-loss-mid-decode`` preset (2 devices lost at decode
              step 4) with 512/1024/2048-token prompts on 4 slots, the
              runner a ring of 8 logical devices under
              ``ServeAutoscaler(8, 4)`` through
              ``repro_torch.launch.serve.serve``, and the same trace with
              no fault: every request served, K6 and K7 launched 6 and 38
              times per prefill, restarts included; the decision (8 -> 6
              devices, its slots, epoch_s and Lemma-1 cores) equal to the
              autoscaler's; TTFT/TPOT p50/p99, restarts, peak memory; a
              stream that differs from the no-fault run (the decode batch
              changes with the slots) is replayed at both batches and held
              to phase 9's greedy-token rule at its first differing token
 20. window   Zamba2-1.2B, full width, bf16: a 33,792-token prompt
              (attn_window 32,768 + 1,024, 264 SSM chunks); the first
              33,664 tokens prefilled through the serving runner's model
              (K6 windowed, 6 launches; K7 38), 16 tokens decoded
              teacher-forced through the KV ring, each step's logits
              (and the prefill's) held to ``forward`` over the whole prompt
              at that position within 4e-2 of the largest logit and the
              greedy-token rule (``forward`` runs the same windowed K6);
              K6 itself on the inputs of the prefill's first call, (1, 32,
              33664, 64) window 32,768, held to its plain version at phase
              7's bf16 bars on every query row, by 128-row slices that
              read only the keys in their window; prefill ms, a profiled
              prefill, K6 ms a call against its bound, peak memory
 21. driver   the LM training driver (``repro_torch.launch.train.train``):
              granite-3-2b at full width cut to 10 of its 40 layers
              (``DRIVER_LAYERS``, the script's running time), bf16, 2 x
              2048 tokens in 2 microbatches, the reference's
              ``TrainSettings``: (a) a
              6-step run dies right after its checkpoint of step index 2;
              (b) a 6-step run in the same directory resumes at step 3;
              (c) runs 6 steps uninterrupted; only (a) checkpoints; (b)'s
              steps 3-5 equal (c)'s bit for bit, or else a second
              uninterrupted run (d) witnesses the step's run-to-run spread:
              where (c) and (d) agree bit for bit the resume fails, else
              it is held within max(2 x their spread, 1e-5 relative);
              each run's K4-K7 launches a step equal to
              ``train_launches`` (K4/K5 twice, K6 40 and its backward
              20); (b) profiled from the end of its restore, its device
              busy time a step and K6's share printed; ms/step, checkpoint bytes,
              snapshot, write and restore ms; the checkpoint goes under
              ``build/``, which must hold 1.5 times it (else Zamba2-1.2B
              is driven), and is removed afterwards
 22. dryrun   the port's dry-runs on the meta device, started after phase
              1 in a process of its own that sees no card
              (``chip_smoke.py --predict DIR``, into ``build/dryrun/``):
              (a) ``launch.dryrun --all`` (10 archs x 4 shapes: each cell
              ok, skipped as the reference skips it, or refused at a
              kernel wrapper's limit) and ``launch.dryrun_fcnn``, a line a
              cell (peak against the card's 80 GB, compute and memory ms,
              bottleneck, seconds); (b) the cells earlier phases run:
              granite-3-2b train 2 x 2048 in 2 microbatches, Zamba2-1.2B
              train 1 x 2048 in bf16 and in fp32, the 2048-token batch-1
              prefill and the
              4-slot decode step at depth 2048 of Zamba2-1.2B, qwen3-14b
              and mamba2-2.7b, the train steps of phases 18d-18f,
              NN1-NN6's executor step at batch 128 on 8 logical devices; (c) granite-3-2b at 1 x 4096, the baseline
              and hillclimb's pure_fsdp+fce+oh+chunk config (fused CE,
              one-hot embedding, chunked attention past 2048²) from the
              same weights, bf16 at full width (loss 2e-2, gradient norm
              5e-2 relative) and fp32 cut to 4 layers (1e-5, 1e-4).  Each
              cell of (b) and (c) runs one profiled step on the card from
              ``reset_peak_memory_stats``, its state allocated after it
              (the fp32 Zamba2-1.2B cell is held to phase 18g's steps and
              profiled step, measured the same way, and takes no step
              here):
              the predicted K1-K7 launches equal the card's, the predicted
              peak within 10% of the card's (FCNN: or 64 MiB), the cell's
              (the state made after the reset) and the step's own, the
              roofline bound no more than the device busy time; the card
              orders the knob variant's and the baseline's step peaks as
              the dry-run does (lower or higher where it predicts lower
              or higher by > 10%, else within 10%: at full width AdamW's
              fp32 temporaries of the largest leaf set both)

 23. bf16     the FCNN in bf16 (``fcnn.init(dtype=torch.bfloat16)``): K1,
              K2 and K3 in case (a) (bf16 data, bf16 network), (b) (fp32
              data, bf16 network: fp32 activations against bf16 weights)
              and (d) (bf16 data, fp32 network) against their plain
              versions at NN1's layers (batch 64), NN5's (batch 128) and
              the ragged (7, 13, 5), (3, 20, 10), (32, 500, 10) and (100,
              64, 64) with every activation; outputs in the reference's
              dtypes, bf16 ones element-wise within 2^-7·|plain| + 1e-4
              of the largest and norm-wise within 2^-7, fp32 ones within
              1e-4 of the largest; K1-K3 repeated bit-identical; with
              bf16 weights ((a), (b)) K1 and K2 run on the tensor cores
              (wgmma; fp32 x and dZ split into bf16 hi + lo), with fp32
              weights ((d)) on the CUDA cores; with bf16 x ((a), (d)) K3
              runs on the tensor cores (dZ split hi + lo), with fp32 x
              ((b)) on the CUDA cores; K2 at a contraction of at most 16
              (the output layers' 10) on the CUDA cores whatever the
              dtypes; each wrapper call must reach the kernel this rule
              names (its ``tc_launches`` counted); at every shape every
              plan of both kernels of K1-K3 ((width, split) of the
              tensor-core one, (split, slice) of K1's and K2's CUDA-core
              one, K3's dW tiles) held to the plain version and run twice
              bit-identical, and at NN1's and NN5's layers
              in case (a) timed beside the plain version, the library
              calls (K1: cuBLAS's bf16 addmm and the act; K2 and K3: the
              fp32 product, dZ·Wᵀ or Xᵀ·dZ and Σ dZ, that computes their
              function, and the bf16 one, which rounds dZ) and the bound,
              and summed over one NN1 step by wrapper, whichever kernel
              each call reached; then NN1, 300 Adam steps at batch 64
              through ``train_fcnn.train_step`` in cases (a) and (b):
              accuracy > 0.8, launches per step equal to the fp32 path's,
              the tensor-core launches a step the rule gives (K1 3 of 3;
              K2 1 of 2; K3 3 of 3 in (a), 0 in (b)), no plain version
              reached (counted), ms/step and a profiled window;
              NN5 in case (a), 5 steps, kernel path against plain path
              from the same weights: losses within 2e-2 relative, step
              1's gradient leaves within 5e-2 of their norms

The last three lines are a JSON object of per-kernel numbers, the card's
name and power limit as nvidia-smi reports them, and the result object.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


GEMM_RTOL = 1e-4    # fp32 sums of up to 4000 terms in another order
XENT_ATOL = 1e-5    # nll, lse and the mean (values of the order of log C)
# dlogits = (p − onehot)·s is held element-wise relative to its size: s is
# g/B (3.4e-4 at the LM's 2048 rows, with p below 1e-4 nearly everywhere),
# so an absolute bar would pass any p.  fp32 within DLOGITS_RTOL of |plain|,
# bf16 within one bf16 ulp (both sides round an fp32 value to bf16), each
# plus DLOGITS_ROW_FLOOR of its row's largest |plain| (p underflows far
# below the row's largest logit)
DLOGITS_RTOL = 1e-5
DLOGITS_ROW_FLOOR = 1e-6

NN1 = [784, 1000, 500, 10]
NN5 = [1024, 4000, 1000, 4000, 10]
ACTS = ("sigmoid", "relu", "tanh", "none")

KERNEL_INFO = {
    # name: (source, TPU kernel it replaces)
    "fcnn_layer": ("src/repro_torch/kernels/csrc/fcnn_fwd.cu",
                   "src/repro/kernels/fcnn_layer.py:142"),
    "fcnn_layer_dgrad": ("src/repro_torch/kernels/csrc/fcnn_dgrad.cu",
                         "src/repro/kernels/fcnn_layer.py:208"),
    "fcnn_layer_wgrad": ("src/repro_torch/kernels/csrc/fcnn_wgrad.cu",
                         "src/repro/kernels/fcnn_layer.py:292"),
    "softmax_xent_fwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/softmax_xent.py:111"),
    "softmax_xent_dlogits": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                             "src/repro/kernels/softmax_xent.py:172"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan.py:60"),
    # K6's backward: no pallas_call, the counterpart of the reference's
    # flash-style VJP _sdpa_chunked_bwd (phases 7 and 18)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:367"),
    # K7's backward: no pallas_call, the counterpart of jax.vjp of the
    # reference's jnp oracle ssd_chunk_ref (phases 7 and 18)
    "ssd_chunk_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                      "src/repro/kernels/ref.py:122"),
    # K1's and K2's kernels for bf16 weights, on the tensor cores (phase 23)
    "fcnn_layer_tc": ("src/repro_torch/kernels/csrc/fcnn_fwd_tc.cu",
                      "src/repro/kernels/fcnn_layer.py:142"),
    "fcnn_layer_dgrad_tc": ("src/repro_torch/kernels/csrc/fcnn_dgrad_tc.cu",
                            "src/repro/kernels/fcnn_layer.py:208"),
    # K3's kernel for bf16 x, on the tensor cores (phase 23)
    "fcnn_layer_wgrad_tc": ("src/repro_torch/kernels/csrc/fcnn_wgrad_tc.cu",
                            "src/repro/kernels/fcnn_layer.py:292"),
}
FCNN_KERNELS = tuple(KERNEL_INFO)[:5]
XENT_KERNELS = ("softmax_xent_fwd", "softmax_xent_dlogits")
# K4/K5 at LM loss shapes (B·L, padded vocabulary): granite-3-2b's
# microbatch of 2048 tokens (the train path, phase 18; granite-moe-1b-a400m's
# too, phase 18d), Zamba2's vocabulary at 4096 tokens, a ragged batch, a
# narrow vocabulary, bf16 logits, and the microbatches of phases 18e
# (seamless-m4t-large-v2: 1024 decoder tokens, 256206 classes padded) and
# 18f (qwen2-vl-72b: 2048 tokens, 152064 classes)
LM_XENT_SHAPES = (("2048x49408", 2048, 49408, "float32"),
                  ("4096x32000", 4096, 32000, "float32"),
                  ("37x49408", 37, 49408, "float32"),
                  ("2048x1000", 2048, 1000, "float32"),
                  ("2048x49408", 2048, 49408, "bfloat16"),
                  ("1024x256256", 1024, 256256, "float32"),
                  ("2048x152064", 2048, 152064, "float32"))
LM_XENT_LABEL = "LM 2048x49408 float32"
# the LM loss shape of each family train path, by arch
LM_XENT_PATHS = {"granite-moe-1b-a400m": LM_XENT_LABEL,
                 "seamless-m4t-large-v2": "LM 1024x256256 float32",
                 "qwen2-vl-72b": "LM 2048x152064 float32"}
LM_KERNELS = ("flash_attention", "ssd_chunk")
# the kernels this script holds to 0 spill bytes in ptxas's report, by a
# substring of their mangled names
NO_SPILL_KERNELS = ("fcnn_fwd_kernel", "dgrad_kernel", "fcnn_wgrad_kernel",
                    "fcnn_fwd_tc_kernel", "fcnn_dgrad_tc_kernel",
                    "fcnn_wgrad_tc_kernel", "flash_fwd_wgmma_kernel",
                    "ssd_chunk_wgmma_kernel",
                    # the fp32 forwards of K6 and K7 (3xTF32)
                    "flash_fwd_tf32_kernel", "ssd_chunk_tf32_kernel",
                    "flash_bwd_prep_kernel", "flash_bwd_wgmma_kernel",
                    "flash_bwd_dq_round_kernel", "flash_bwd_prep_f32_kernel",
                    "flash_bwd_tf32_kernel", "flash_bwd_dq_sum_kernel",
                    # K7's backward: the bf16 kernel and the fp32 one (a
                    # block the heads of a B/C group), and the sum of a
                    # group's blocks' parts
                    "ssd_bwd_wgmma_kernel", "ssd_bwd_tf32_kernel",
                    "group_sum_kernel")
# K1's and K2's bf16-weight kernels, K3's bf16-x kernel, the bf16 K6
# kernel and its backward's fused kernel, and the bf16 K7 kernel and its
# backward, which must run on the tensor cores (HGMMA in their SASS) with
# no wgmma serialized by ptxas
TC_KERNELS = ("fcnn_fwd_tc_kernel", "fcnn_dgrad_tc_kernel",
              "fcnn_wgrad_tc_kernel", "flash_fwd_wgmma_kernel",
              "ssd_chunk_wgmma_kernel", "flash_bwd_wgmma_kernel",
              "ssd_bwd_wgmma_kernel")
# the fp32 forwards and backwards of K6 and K7, whose products run on the
# tensor cores as 3xTF32 on mma.sync (HMMA in their SASS), held to no
# spills as well
MMA_KERNELS = ("flash_fwd_tf32_kernel", "ssd_chunk_tf32_kernel",
               "flash_bwd_tf32_kernel", "ssd_bwd_tf32_kernel")
# the kernels whose consumer warpgroups take registers from the producer
# warpgroup with setmaxnreg, and the count each must be launched with: 384
# threads at 168, of which the producer's 128 x (168 − 24) pay for two
# warpgroups at 240; at fewer, setmaxnreg.inc would wait for registers no
# warpgroup frees
SETMAXNREG_KERNELS = (("flash_bwd_wgmma_kernel", 168),)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def phase(n: int | str, name: str) -> None:
    print(f"\n=== phase {n}: {name}  (t = {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- measuring


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` called back to back, from CUDA events:
    the larger of its device time and its host cost (Python, checks,
    launch), as an eager training loop sees it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, µs) of every device operation a profiler recorded."""
    from torch.autograd import DeviceType

    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost per call drops out (inputs warm in L2, as between the periods of
    a training step)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def h100():
    """The H100 SXM data-sheet peaks the dry-run prices with
    (``core.planner.H100Target``: HBM bandwidth, fp32 outside the tensor
    cores, dense bf16 on them).  Imported on use, as every module of the
    port here: ``tools/ab_*.py`` import this script before they pick whose
    ``src`` to load."""
    from repro_torch.core.planner import H100Target

    return H100Target()


def bound(cost) -> tuple[float, str]:
    """(ms, what bounds it) of a launch's ``kernels.cost.Cost`` (every
    bound here counts a kernel's work as the dry-run does): the larger of
    its bytes over the HBM rate and its operations over the peak rate of
    their type."""
    t_ops, t_bytes = (t * 1e3 for t in cost.seconds(h100()))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dlogits_error(out, want) -> float:
    """K5's worst element as a share of its bar (<= 1 passes): |out − want|
    over rtol·|want| + DLOGITS_ROW_FLOOR·(its row's largest |want|), rtol
    DLOGITS_RTOL for fp32 and BF16_ULP for bf16.  Where the bar is 0 (a
    row whose factor is 0) the two must be equal."""
    o, w = out.double(), want.double()
    rtol = BF16_ULP if out.element_size() == 2 else DLOGITS_RTOL
    bar = rtol * w.abs() + DLOGITS_ROW_FLOOR * w.abs().amax(-1, keepdim=True)
    tiny = 2.2250738585072014e-308
    return ((o - w).abs() / bar.clamp_min(tiny)).max().item()


def errors(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    abs_err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return abs_err, abs_err / max(scale, 1e-30)


# --------------------------------------------------------------- phase 2


def build_extension():
    """Build the extension verbosely, copying the compiler's output
    (written to file descriptor 1 by the build's subprocess) to a file in
    the build directory; return (extension, that output)."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = _build.BUILD_DIR / "build_output.txt"
    sys.stdout.flush()
    saved, ext = os.dup(1), None
    try:
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            ext = _build.extension(verbose=True)
            sys.stdout.flush()
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        if ext is None:   # the build failed: show why before raising
            print(log.read_text(), flush=True)
    return ext, log.read_text()


def ptxas_report(text: str) -> dict[str, dict]:
    """{mangled kernel: {registers, smem, spill_stores, spill_loads}} from
    ``-Xptxas=-v`` output."""
    import re

    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {"registers": None, "smem": 0, "spill_stores": None,
                            "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name]["spill_stores"] = int(m.group(1))
            report[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(m.group(1)) if m else 0
    return report


def sass_counts(library: str) -> dict[str, dict[str, int]]:
    """{mangled kernel: {HGMMA, HMMA, FFMA: instruction count}} from
    ``cuobjdump -sass`` of the built extension."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif name is not None and "/*" in line:
            op = line.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
            if op.startswith("@"):   # predicated: the opcode follows
                op = line.split("*/", 1)[-1].strip().split(" ")[1].split(".")[0]
            if op in counts[name]:
                counts[name][op] += 1
    return counts


def run_build_phase() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    ext, text = build_extension()
    print(text, end="")
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)
    report = ptxas_report(text)
    if not report:
        print("ptxas report: none (the extension was loaded from an earlier "
              "build in this directory)")
    for name, r in report.items():
        if any(k in name for k in NO_SPILL_KERNELS):
            print(f"ptxas {name[:90]}: {r['registers']} registers, "
                  f"{r['smem']} bytes static smem, spill stores "
                  f"{r['spill_stores']} loads {r['spill_loads']} bytes")
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"{name} spills registers")
    counts = sass_counts(ext.__file__)
    print("SASS instructions per kernel (HGMMA HMMA FFMA):")
    for name, c in counts.items():
        print(f"  {c['HGMMA']:5d} {c['HMMA']:5d} {c['FFMA']:6d}  {name[:100]}")
    for kernel in TC_KERNELS:
        found = [c for name, c in counts.items() if kernel in name]
        check(bool(found) and all(c["HGMMA"] > 0 for c in found),
              f"{kernel} has no HGMMA in its SASS")
    for kernel in MMA_KERNELS:
        found = [c for name, c in counts.items() if kernel in name]
        check(bool(found) and all(c["HMMA"] > 0 for c in found),
              f"{kernel} has no HMMA in its SASS")
    serial = [line.strip() for line in text.splitlines()
              if "wgmma.mma_async instructions are serialized" in line]
    for line in serial:
        print(line[:300])
    check(not any(k in line for line in serial
                  for k in TC_KERNELS + MMA_KERNELS),
          "ptxas serializes the wgmma of a tensor-core kernel")
    ignored = [line.strip() for line in text.splitlines()
               if "setmaxnreg ignored" in line]
    check(not ignored, f"ptxas ignores setmaxnreg: {ignored[:2]}")
    for kernel, regs in SETMAXNREG_KERNELS:
        found = [r for name, r in report.items() if kernel in name]
        if report:
            check(bool(found) and all(r["registers"] == regs for r in found),
                  f"{kernel} must be launched with {regs} registers a thread "
                  f"for its setmaxnreg: {[r['registers'] for r in found]}")


# --------------------------------------------------------------- phase 3


class Case(NamedTuple):
    """One comparison of phase 3.  ``cost`` is the launch's work
    (``kernels.cost``: each input read once and each output written once;
    a multiply-add is 2 operations, each element-wise step 1).
    ``forced(*choice)`` runs a kernel
    with a host plan at one of the CHOICES of its kind: K1 and K2 at a
    (split, slice), K3 at a dW tile (rows, columns); ``plan`` is the
    choice its wrapper makes."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    lib: Callable
    cost: object
    timed: bool
    on_path: bool
    plan: tuple | str | None = None
    forced: Callable | None = None


# the plans each kernel with a host plan takes: (split, slice) of the
# cluster split-K kernels, the dW tile (rows, columns) of K3
# the cluster splits of K1's and K2's tensor-core kernels (phase 23), and
# of K3's, whose contraction, the batch, is one or two slices of 64 rows at
# NN1-NN6 (split 4 leaves ranks idle)
TC_SPLITS = (1, 2, 4, 8, 16)
WGRAD_TC_SPLITS = (1, 2, 4)
CHOICES = {
    "fcnn_layer": [(s, sl) for s in (1, 2, 4, 8, 16) for sl in (16, 32)],
    "fcnn_layer_dgrad": [(s, sl) for s in (1, 2, 4, 8) for sl in (16, 32)],
    "fcnn_layer_wgrad": [(64, 64), (128, 64), (128, 128)],
}


def kernel_cases(torch, dev, gen, shapes=None):
    """Yield a Case for every comparison of phase 3, or, given ``shapes``
    (rows of (tag, batch, n_in, n_out, activation, timed)), K1, K2 and K3
    at each of those shapes."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.fcnn_layer import (
        act_code,
        dgrad_plan,
        fcnn_layer,
        fcnn_layer_dgrad,
        fcnn_layer_wgrad,
        fwd_plan,
        wgrad_plan,
    )
    from repro_torch.kernels.softmax_xent import (softmax_xent_dlogits,
                                                  softmax_xent_fwd,
                                                  vector_loads)
    from repro_torch.kernels.softmax_xent import fwd_plan as xent_fwd_plan
    F = torch.nn.functional
    lib_act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
               "tanh": torch.tanh, "none": lambda z: z}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def layer_cases(tag, sizes, batch, acts_for=None, timed=True,
                    on_path=False):
        l = len(sizes) - 1
        ext = _build.extension()
        for i in range(l):
            k, n = sizes[i], sizes[i + 1]
            acts = acts_for or (("sigmoid",) if i < l - 1 else ("none",))
            for act in acts:
                m = batch
                x, w = rand(m, k), rand(k, n, scale=k ** -0.5)
                b, dy = rand(n, scale=0.1), rand(m, n, scale=0.01)
                y = ref.fcnn_layer_ref(x, w, b, act)
                dz = ref.act_deriv_from_output(y, act) * dy
                lab = f"{tag} L{i + 1} {m}x{k}x{n} {act}"

                def fwd_forced(split, slice_, x=x, w=w, b=b, a=act):
                    out = torch.empty(x.shape[0], w.shape[1], device=dev)
                    ext.fcnn_fwd(x, w, b, out, act_code(a), split, slice_)
                    return out

                def dgrad_forced(split, slice_, dy=dy, y=y, w=w, a=act):
                    dx = torch.empty(dy.shape[0], w.shape[0], device=dev)
                    ext.fcnn_dgrad(dy, y, w, dx, act_code(a), split, slice_)
                    return dx

                def wgrad_forced(rows, cols, x=x, dy=dy, y=y, a=act):
                    dw = torch.empty(x.shape[1], dy.shape[1], device=dev)
                    db = torch.empty(dy.shape[1], device=dev)
                    ext.fcnn_wgrad(x, dy, y, dw, db, act_code(a), rows, cols)
                    return dw, db

                # the step skips dgrad of layer 1 (its input needs no grad)
                yield Case("fcnn_layer", lab,
                           lambda x=x, w=w, b=b, a=act: fcnn_layer(x, w, b, a),
                           lambda x=x, w=w, b=b, a=act: ref.fcnn_layer_ref(x, w, b, a),
                           lambda x=x, w=w, b=b, a=act: lib_act[a](torch.addmm(b, x, w)),
                           kcost.fcnn_fwd(m, k, n), timed, on_path,
                           fwd_plan(m, k, n), fwd_forced)
                yield Case("fcnn_layer_dgrad", lab,
                           lambda dy=dy, y=y, w=w, a=act: fcnn_layer_dgrad(dy, y, w, a),
                           lambda dy=dy, y=y, w=w, a=act: ref.fcnn_layer_dgrad_ref(dy, y, w, a),
                           lambda dz=dz, w=w: dz @ w.T,
                           kcost.fcnn_dgrad(m, k, n), timed, on_path and i > 0,
                           dgrad_plan(m, k, n), dgrad_forced)
                yield Case("fcnn_layer_wgrad", lab,
                           lambda x=x, dy=dy, y=y, a=act: fcnn_layer_wgrad(x, dy, y, a),
                           lambda x=x, dy=dy, y=y, a=act: ref.fcnn_layer_wgrad_ref(x, dy, y, a),
                           lambda x=x, dz=dz: (x.T @ dz, dz.sum(0)),
                           kcost.fcnn_wgrad(m, k, n), timed, on_path,
                           wgrad_plan(k, n), wgrad_forced)

    def xent_cases(tag, b, c, dtype=torch.float32, timed=True,
                   on_path=False):
        x = rand(b, c, scale=3.0).to(dtype)
        lab = torch.randint(0, c, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        lab64 = lab.long()
        onehot = F.one_hot(lab64, c).float()
        _, lse, _ = ref.softmax_xent_fwd_ref(x, lab)
        g = torch.tensor(0.7, device=dev)
        e = x.element_size()
        label = f"{tag} {b}x{c} {str(dtype)[6:]}"
        aligned = x.data_ptr() % 16 == 0
        # K4 writes (nll, lse, mean); K5 takes the loss cotangent g as the
        # training step hands it over; each with the launch its host plan
        # picked
        yield Case("softmax_xent_fwd", label,
                   lambda: softmax_xent_fwd(x, lab),
                   lambda: ref.softmax_xent_fwd_ref(x, lab),
                   lambda: F.cross_entropy(x, lab64, reduction="none"),
                   kcost.xent_fwd(b, c, e), timed, on_path,
                   xent_fwd_plan(b, c, e, aligned))
        yield Case("softmax_xent_dlogits", label,
                   lambda: softmax_xent_dlogits(x, lab, lse, g=g),
                   lambda: ref.softmax_xent_dlogits_ref(x, lab, lse, g=g),
                   lambda: torch.softmax(x.float(), -1) - onehot,
                   kcost.xent_dlogits(b, c, e), timed, on_path,
                   f"vec={vector_loads(c, e, aligned)}")

    if shapes is not None:
        for tag, m, k, n, act, timed in shapes:
            yield from layer_cases(tag, [k, n], m, acts_for=(act,),
                                   timed=timed)
        return
    yield from layer_cases("NN1", NN1, 64, on_path=True)
    yield from xent_cases("NN1", 64, 10, on_path=True)
    yield from xent_cases("NN1", 64, 10, torch.bfloat16)
    yield from layer_cases("NN5", NN5, 128)
    for dtype in (torch.float32, torch.bfloat16):
        yield from xent_cases("NN5", 128, 10, dtype)
    # edges: batch 1, N = 10, K = 784, every activation
    yield from layer_cases("edge", [784, 10], 1, acts_for=ACTS, timed=False)
    yield from layer_cases("edge", NN1[:2], 64, acts_for=ACTS, timed=False)
    for dtype in (torch.float32, torch.bfloat16):
        yield from xent_cases("edge", 1, 10, dtype, timed=False)
        yield from xent_cases("edge", 37, 300, dtype, timed=False)
    for _, b, c, dtype in LM_XENT_SHAPES:
        yield from xent_cases("LM", b, c, getattr(torch, dtype))


def worst_errors(out, want) -> tuple[float, float]:
    """errors() over the outputs of a call (a tensor or a tuple)."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    worst_abs = worst_rel = 0.0
    for o, w in zip(outs, wants):
        a, r = errors(o, w)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    return worst_abs, worst_rel


SWEEP_KIND = {"fcnn_layer": "split/slice", "fcnn_layer_dgrad": "split/slice",
              "fcnn_layer_wgrad": "tile"}


def _choice_name(case: Case, choice: tuple[int, ...]) -> str:
    sep = "x" if case.name == "fcnn_layer_wgrad" else "/"
    return sep.join(map(str, choice))


def _agrees(case: Case, out, want) -> tuple[bool, float, str]:
    """(ok, the error the bar is on, the bar): GEMMs relative to the
    largest output, K4 absolute, K5 element-wise (``dlogits_error``, in
    units of its bar)."""
    worst_abs, worst_rel = worst_errors(out, want)
    if case.name.startswith("fcnn"):
        return worst_rel <= GEMM_RTOL, worst_rel, f"rel<={GEMM_RTOL:g}"
    if case.name == "softmax_xent_dlogits":
        err = dlogits_error(out, want)
        rtol = "2^-7" if out.element_size() == 2 else f"{DLOGITS_RTOL:g}"
        return err <= 1, err, (f"|d|<={rtol}|ref|+{DLOGITS_ROW_FLOOR:g}"
                               f"*rowmax at {err:.3f} of it")
    return worst_abs <= XENT_ATOL, worst_abs, f"abs<={XENT_ATOL:g}"


def sweep_line(torch, case: Case, want) -> str:
    """Device ms of a kernel with a host plan at every choice it takes,
    each held to the plain version's output ``want``; the plan's choice and
    the fastest are named."""
    times = {}
    for choice in CHOICES[case.name]:
        out = case.forced(*choice)
        torch.cuda.synchronize()
        ok, err, _ = _agrees(case, out, want)
        check(ok, f"{case.name} {case.label} at {choice}: error {err:.3e}")
        times[choice] = device_ms(lambda c=choice: case.forced(*c))
    best = min(times, key=times.get)
    cells = " ".join(f"{_choice_name(case, c)} {ms:.5f}"
                     for c, ms in times.items())
    return (f"    sweep {SWEEP_KIND[case.name]} device ms: {cells} | plan "
            f"{_choice_name(case, case.plan)} {times[case.plan]:.5f}, fastest "
            f"{_choice_name(case, best)} {times[best]:.5f}")


def run_kernel_phase(torch, dev, shapes=None) -> dict:
    """Phase 3's comparisons (or those of ``kernel_cases``' ``shapes``);
    returns per-kernel sums over the NN1 step's calls and, in "rows", the
    device ms (kernel, plain, library, bound) of every timed case."""
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                      "ops_ms": 0.0, "shapes": [], "rows": {}}
               for name in FCNN_KERNELS}
    for case in kernel_cases(torch, dev, gen, shapes):
        name, label = case.name, case.label
        out, want = case.kern(), case.plain()
        torch.cuda.synchronize()
        worst_abs, worst_rel = worst_errors(out, want)
        ok, _, tol = _agrees(case, out, want)
        extra = ""
        if name == "fcnn_layer_wgrad":
            extra = f" tile {case.plan[0]}x{case.plan[1]}"
        elif name.startswith("fcnn"):  # split-K sums in a fixed order
            same = torch.equal(out, case.kern())
            extra = (f" split/slice {case.plan[0]}/{case.plan[1]} repeat "
                     f"{'bit-identical' if same else 'DIFFERS'}")
            ok = ok and same
        elif name == "softmax_xent_fwd":  # the mean in a fixed order
            same = torch.equal(out[2], case.kern()[2])
            extra = (f" mean repeat {'bit-identical' if same else 'DIFFERS'}"
                     f" {case.plan}")
            ok = ok and same
        else:
            extra = f" {case.plan}"
        line = (f"{name:21s} {label:32s} max_abs {worst_abs:.3e} "
                f"max_rel {worst_rel:.3e} ({tol}){extra} "
                f"{'ok' if ok else 'FAIL'}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], worst_abs)
        if case.timed:
            ms, plain_ms, lib_ms = (device_ms(case.kern), device_ms(case.plain),
                                    device_ms(case.lib))
            b_ms, b_by = bound(case.cost)
            s["rows"][label] = (ms, plain_ms, lib_ms, b_ms)
            line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                     f"library {lib_ms:.5f} bound {b_ms:.7f} ({b_by}) | "
                     f"eager ms: kernel {eager_ms(case.kern):.5f} plain "
                     f"{eager_ms(case.plain):.5f}"
                     f"{' [NN1 step]' if case.on_path else ''}")
            if case.on_path:
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["library_ms"] += lib_ms
                s["bound_ms"] += b_ms
                ops_s, bytes_s = case.cost.seconds(h100())
                s["bytes_ms"] += bytes_s * 1e3
                s["ops_ms"] += ops_s * 1e3
                s["shapes"].append(label)
        print(line, flush=True)
        check(ok, f"{name} {label} disagrees with its plain version")
        if case.timed and case.forced is not None:
            print(sweep_line(torch, case, want), flush=True)
    for name in FCNN_KERNELS if shapes is None else ():
        s = summary[name]
        print(f"NN1 step, {name}: kernel {s['ms']:.5f} ms, library "
              f"{s['library_ms']:.5f} ms, plain {s['plain_ms']:.5f} ms, bound "
              f"{s['bound_ms']:.7f} ms over {len(s['shapes'])} calls")
    return summary


def nn1_step_parts(torch, dev):
    """(params, leaves, batch, Adam, its state, step counter) of an NN1
    training step at batch 64."""
    from repro_torch.data import fcnn_classification_dataset
    from repro_torch.launch.train_fcnn import FULL_RUN_STEPS, LR
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    params = fcnn.init(NN1, torch.Generator().manual_seed(0), dev)
    x, y = fcnn_classification_dataset(64, input_dim=NN1[0], seed=0)
    batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    return (params, fcnn.parameters(params), batch, opt, opt.init(params),
            torch.zeros((), device=dev))


def run_floor_and_chain(torch, dev, summary) -> None:
    """K4 and K5 beside an empty kernel timed the same way (the launch
    floor), and one NN1 step's forward and backward (loss_fn, then
    autograd.grad: K1 x3, K4, K5, K3 x3, K2 x2 and autograd's own
    operations) captured in a CUDA graph."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train_fcnn import train_step
    from repro_torch.models import fcnn

    ext = _build.extension()
    floor = device_ms(ext.launch_floor)
    print(f"launch floor, an empty kernel in the same harness (CUDA-graph "
          f"replay): {floor:.5f} ms")
    for name in ("softmax_xent_fwd", "softmax_xent_dlogits"):
        ms = summary[name]["ms"]
        print(f"  {name} at NN1 (64x10 fp32): {ms:.5f} ms = "
              f"{ms / floor:.2f}x the floor")
    params, leaves, batch, opt, state, step_t = nn1_step_parts(torch, dev)

    def fwd_bwd():
        return torch.autograd.grad(fcnn.loss_fn(params, batch), leaves)

    def step():
        train_step(params, opt, state, batch, step_t)

    print(f"NN1 step chain, forward+backward in a CUDA graph: "
          f"{device_ms(fwd_bwd, iters=10, replays=30):.5f} ms device")
    print(f"NN1 step as the port runs it: forward+backward eager "
          f"{eager_ms(fwd_bwd, iters=100):.5f} ms, whole Adam step "
          f"{eager_ms(step, iters=100):.5f} ms (CUDA events, host included)")


# --------------------------------------------------------------- phase 4


def run_autograd_phase(torch, dev) -> None:
    from repro_torch.data import fcnn_classification_dataset
    from repro_torch.models import fcnn

    gen = torch.Generator().manual_seed(1)
    params = fcnn.init(NN1, gen, dev)
    x, y = fcnn_classification_dataset(64, input_dim=NN1[0], seed=3)
    batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    leaves = fcnn.parameters(params)
    loss_k = fcnn.loss_fn(params, batch)
    g_k = torch.autograd.grad(loss_k, leaves)
    loss_p = fcnn.loss_fn(params, batch, kernel_mode="ref")
    g_p = torch.autograd.grad(loss_p, leaves)
    d_loss = abs(loss_k.item() - loss_p.item())
    print(f"loss kernel {loss_k.item():.7f} plain {loss_p.item():.7f} "
          f"|diff| {d_loss:.3e} (<= {XENT_ATOL:g})")
    check(d_loss <= XENT_ATOL, "fused loss disagrees with the plain loss")
    names = [f"{k}{i + 1}" for i in range(len(NN1) - 1) for k in ("w", "b")]
    for name, a, b in zip(names, g_k, g_p):
        abs_err, rel_err = errors(a, b)
        print(f"grad {name:3s} {tuple(a.shape)!s:12s} max_abs {abs_err:.3e} "
              f"max_rel {rel_err:.3e} (rel<={GEMM_RTOL:g})")
        check(rel_err <= GEMM_RTOL, f"gradient of {name} disagrees")


# ------------------------------------------------------------ phase 5b

PROFILE_STEPS = 50


def run_profile_phase(torch, dev) -> None:
    """Where one NN1 training step's time goes (``profile_steps``)."""
    from repro_torch.data import Batcher, fcnn_classification_dataset
    from repro_torch.launch.train_fcnn import FULL_RUN_STEPS, LR, train_step
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    params = fcnn.init(NN1, torch.Generator().manual_seed(0), dev)
    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    state = opt.init(params)
    x, y = fcnn_classification_dataset(4096, input_dim=NN1[0], seed=0)
    batches = Batcher({"x": x, "y": y}, batch_size=64, device=dev)
    step_t = torch.zeros((), device=dev)
    profile_steps(torch, lambda: train_step(params, opt, state, next(batches),
                                            step_t))


def profile_steps(torch, step: Callable[[], object]) -> tuple[float, float]:
    """profile_runs of ``step`` called over and over."""
    def steps(n: int) -> None:
        for _ in range(n):
            step()
        torch.cuda.synchronize()

    return profile_runs(torch, steps)


def profile_runs(torch, steps: Callable[[int], None]) -> tuple[float, float]:
    """Host ms/step of ``steps(n)`` (which runs n steps and waits for the
    device) with the profiler off, then device busy time per step and the
    top device operations from torch.profiler over as many steps; returns
    (host ms/step, device operations/step)."""
    from torch.profiler import ProfilerActivity, profile

    steps(10)   # warm up
    t0 = time.perf_counter()
    steps(PROFILE_STEPS)
    host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    print(f"host clock, profiler off: {host_ms:.4f} ms/step over "
          f"{PROFILE_STEPS} steps")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(PROFILE_STEPS)
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return host_ms, 0.0
    busy_ms = sum(us for _, _, us in rows) / 1e3 / PROFILE_STEPS
    launches = sum(c for _, c, _ in rows) / PROFILE_STEPS
    print(f"device busy {busy_ms:.5f} ms/step over {launches:.1f} device "
          f"operations/step = {100 * busy_ms / host_ms:.2f}% of the "
          f"profiler-off step (idle {100 - 100 * busy_ms / host_ms:.2f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / PROFILE_STEPS:9.3f} us/step {count / PROFILE_STEPS:5.1f}"
              f" calls/step  {key[:100]}")
    return host_ms, launches


# --------------------------------------------------------------- phase 7

K6_FP32_RTOL = 2e-5    # of the largest output: fp32 sums in another order
K7_FP32_RTOL = 1e-5
# A bf16 output is held element-wise to BF16_ULP·|plain| (both sides round
# their fp32 result to bf16: one ulp apart at most) plus a slack, and as a
# whole to ||out − plain||_2 <= BF16_ULP·||plain||_2.  K6's slack is
# BF16_ULP·(softmax @ |v|): the kernel rounds exp(s − running max) to bf16
# before PV, as the TPU kernel does, where the plain version rounds the
# normalised softmax, so each probability may differ by one rounding of
# each.  K7's slack is 1e-3 of the largest output (fp32 sums in another
# order).
BF16_ULP = 2.0 ** -7
K7_BF16_SLACK = 1e-3
K7_BF16_STATE_RTOL = 1e-3  # fp32 state and decay from bf16 inputs
# K7's backward against its plain version (``ref.ssd_chunk_bwd_ref``: the
# formulas in fp32, each gradient rounded once, dB and dC summed over each
# group in fp32 first) on the same inputs.  dx, dB, dC: fp32 within
# K7_BWD_FP32_RTOL of their largest element (sums of up to Q·N terms in
# another order); bf16 ``rounded_once`` (the kernel passes S∘L, dS and dst
# as bf16 hi + lo: one rounding of any of them flips ~40% of one gradient's
# roundings, tests/test_torch_ssd_bwd.py).  d(dt_a), fp32 in both dtypes,
# within K7_BWD_DT_RTOL of its largest plus ``k7_bwd_noise``: each element
# is a difference of row and column sums of dS∘S then a reverse cumsum
# over the chunk, so the fp32 noise of the summed terms, not its size, can
# set the bar (the CPU tests show the bar still catches a dropped decay
# cotangent).
K7_BWD_FP32_RTOL = 1e-4
K7_BWD_DT_RTOL = 1e-5
K7_BWD_NOISE = 2.0 ** -20     # 16 fp32 ulps of a term's bound
# bf16 full-width prefill logits, kernel path against plain path, as a
# share of the largest logit: 2.0% measured at 2048 tokens (38 layers of
# bf16 rounding of differently ordered sums, random weights)
BF16_LOGIT_RTOL = 4e-2
ARCH = "zamba2-1.2b"
DENSE_ARCH = "qwen3-14b"
MOE_ARCH = "qwen2-moe-a2.7b"
SSM_ARCH = "mamba2-2.7b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "qwen2-vl-72b"
SERVE_BUCKETS = (512, 1024, 2048)
# the K6 shape of each path's prefill: (B, H, KV, Sq, D, Sk, causal); the
# encoder-decoder's is its cross-attention (512 decoder tokens over 1024
# encoder frames, phase 16)
K6_PATHS = {ARCH: (1, 32, 32, 2048, 64, 2048, True),
            DENSE_ARCH: (1, 40, 8, 2048, 128, 2048, True),
            MOE_ARCH: (1, 16, 16, 2048, 128, 2048, True),
            ENCDEC_ARCH: (1, 16, 16, 512, 64, 1024, False),
            VLM_ARCH: (1, 64, 8, 2048, 128, 2048, True)}
# the K7 shape of each path's 2048-token prefill: (BC, Q, H, P, N), one
# B/C group broadcast to the heads (stride 0)
K7_PATHS = {ARCH: (16, 128, 64, 64, 64), SSM_ARCH: (16, 128, 80, 64, 128)}


def _close(torch, out, want, fp32_rtol, slack) -> tuple[bool, float, str]:
    """(ok, max abs error, criterion and margins) for one output against
    its plain version: relative to the largest value in fp32; for a bf16
    output, element-wise BF16_ULP·|ref| + ``slack()`` (K7_BF16_SLACK of the
    largest value where ``slack`` is None) and norm-wise BF16_ULP."""
    a, r = errors(out, want)
    if out.dtype != torch.bfloat16:
        return r <= fp32_rtol, a, f"rel<={fp32_rtol:g}"
    o, w = out.double(), want.double()
    extra = (K7_BF16_SLACK * w.abs().max() if slack is None
             else slack().double())
    # where the bar is 0 (K6 with window 1 over a v element that is 0)
    # the two must be equal
    bar = (BF16_ULP * w.abs() + extra).clamp_min(2.2250738585072014e-308)
    worst = ((o - w).abs() / bar).max().item()
    norm = ((o - w).norm() / w.norm()).item()
    name = "2^-7(|ref|+P|v|)" if slack is not None else "2^-7|ref|+1e-3max"
    ok = worst <= 1 and norm <= BF16_ULP
    return ok, a, (f"|d|<={name} at {worst:.3f} of it, ||d||/||ref|| "
                   f"{norm:.2e}<=2^-7")


class LMCase(NamedTuple):
    """One comparison of phase 7.  ``cost`` is the launch's work
    (``kernels.cost``): each input read once (a stride-0 B/C once per
    chunk, K and V once per KV head) and each output written once; the
    operations these inputs need (kept pairs only, 2 per multiply-add), at
    the peak their products run at (fp32: three TF32 products each).
    ``slack()`` is K6's bf16 slack, BF16_ULP·(softmax @ |v|) (None: K7's);
    ``forced(heads)`` runs K7 at one of ``choices`` heads per block
    (ssd_scan.SSD_HEADS in bf16, SSD_BWD_HEADS dividing H in fp32),
    ``plan`` being its wrapper's; ``on_path`` names the serving path whose
    prefill runs this shape ("" for none); ``window`` is K6's sliding
    window (0: none), and ``exact()``, where given, the output the kernel
    must return bit for bit (window 1: v itself); ``plain64()``, for fp32
    inputs, the plain version run in float64 on the same inputs (the
    float64 witness)."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    slack: Callable | None
    lib: Callable | None
    cost: object
    timed: bool
    on_path: str
    plan: int | None = None
    forced: Callable | None = None
    window: int = 0
    exact: Callable | None = None
    plain64: Callable | None = None
    choices: tuple = ()


# K6 with a sliding causal window: Zamba2's shared attention (1, 32, S, 64)
# and qwen3-14b's GQA (1, 40, S, 128) on 8 KV heads, windows inside one
# tile, at 64- and 128-row tile edges, and wider
K6_WINDOW_SHAPES = ((1, 32, 32, 64), (1, 40, 8, 128))   # (B, H, KV, D)
K6_WINDOW_SEQS = (2048, 4096)
K6_WINDOWS = (1, 63, 64, 65, 127, 128, 129, 1000)


def lm_kernel_cases(torch, dev, gen):
    """Yield an LMCase for every comparison of phase 7."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import (SSD_BWD_HEADS, SSD_HEADS,
                                              ssd_bwd_plan, ssd_chunk,
                                              ssd_plan)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def flash_case(b, h, s, d, dtype, causal, timed, kv=None, sk=None,
                   window=0):
        # the model's layout: (B, S, H, D) projections seen as (B, H, S, D);
        # k and v with kv heads (GQA, h // kv query heads a group) and sk
        # rows (cross-attention where sk != s); a causal window keeps the
        # ``window`` most recent keys of each query
        kv, sk = kv or h, sk or s
        q = rand(b, s, h, d, dtype=dtype).transpose(1, 2)
        k, v = (rand(b, sk, kv, d, dtype=dtype).transpose(1, 2)
                for _ in range(2))
        e = q.element_size()
        label = (f"({b},{h},{s},{d}){f' kv {kv}' if kv != h else ''}"
                 f"{f' over Sk {sk}' if sk != s else ''} "
                 f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
                 f"{f' window {window}' if window else ''}")
        path = [a for a, shape in K6_PATHS.items()
                if (b, h, kv, s, d, sk, causal) == shape and not window]
        if window:      # SDPA with the same boolean mask
            mask = ref.attention_mask(s, s, window, dev)
            lib = lambda: sdpa(q, k, v, attn_mask=mask,  # noqa: E731
                               enable_gqa=kv != h)
        else:
            lib = lambda: sdpa(q, k, v, is_causal=causal,  # noqa: E731
                               enable_gqa=kv != h)
        exact = (lambda: v.repeat_interleave(h // kv, dim=1)) if window == 1 \
            else None
        plain64 = (lambda: ref.flash_attention_ref(  # noqa: E731
            q.double(), k.double(), v.double(), causal, window)) \
            if dtype == torch.float32 else None
        yield LMCase(
            "flash_attention", label,
            lambda: flash_attention(q, k, v, causal, window),
            lambda: ref.flash_attention_ref(q, k, v, causal, window),
            lambda: BF16_ULP * ref.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal, window),
            lib, kcost.flash_attention(b, h, kv, s, sk, d, e, causal, window),
            timed, path[0] if path else "", window=window, exact=exact,
            plain64=plain64)

    def ssd_case(bc, q, h, p, n, dtype, shared_bc, timed):
        x = rand(bc, q, h, p, dtype=dtype)
        dt_a = -rand(bc, q, h).abs() * 0.3
        g = 1 if shared_bc else h
        b = rand(bc, q, g, n, dtype=dtype).expand(bc, q, h, n)
        c = rand(bc, q, g, n, dtype=dtype).expand(bc, q, h, n)
        e = x.element_size()
        bf16 = dtype == torch.bfloat16
        label = (f"BC={bc} ({q},{h},{p},{n}) {str(dtype)[6:]}"
                 f"{' stride-0 b/c' if shared_bc else ''}")

        def forced(heads):
            y = torch.empty_like(x)
            state = torch.empty((bc, h, p, n), device=dev)
            decay = torch.empty((bc, q, h), device=dev)
            _build.extension().ssd_chunk(x, dt_a, b, c, y, state, decay, heads)
            return y, state, decay

        path = [a for a, shape in K7_PATHS.items()
                if (bc, q, h, p, n) == shape and shared_bc]
        plan = (ssd_plan(bc, h, q, shared_bc, n) if bf16
                else ssd_bwd_plan(bc, h, q, 1 if shared_bc else h, n))
        choices = (tuple(sorted(SSD_HEADS)) if bf16
                   else tuple(k_ for k_ in SSD_BWD_HEADS if h % k_ == 0))
        yield LMCase(
            "ssd_chunk", label,
            lambda: ssd_chunk(x, dt_a, b, c),
            lambda: ref.ssd_chunk_ref(x, dt_a, b, c),
            None, None, kcost.ssd_chunk(bc, q, h, p, n, g, e), timed,
            path[0] if path else "", plan,
            forced if timed and shared_bc else None,
            plain64=None if bf16 else lambda: ref.ssd_chunk_ref(
                x.double(), dt_a.double(), b.double(), c.double()),
            choices=choices)

    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for s in (128, 512, 1024, 2048):
                yield from flash_case(1, 32, s, 64, dtype, causal, True)
            for shape in ((1, 32, 8, 64), (1, 32, 100, 64), (2, 4, 300, 128),
                          (1, 2, 128, 32), (2, 4, 256, 64), (1, 1, 64, 128)):
                yield from flash_case(*shape, dtype, causal, False)
        # GQA: qwen3-14b's prefill (40 query heads on 8 KV heads, D 128),
        # then groups of 1, 4 and 5 at the edges of S and D
        for s in (512, 1024, 2048):
            yield from flash_case(1, 40, s, 128, dtype, True, True, kv=8)
        # qwen2-moe-a2.7b's prefill: 16 heads, D 128, no GQA
        for s in (512, 1024, 2048):
            yield from flash_case(1, 16, s, 128, dtype, True, True)
        for causal in (True, False):
            for b, h, kv, s, d in ((1, 8, 8, 100, 128), (2, 8, 2, 300, 64),
                                   (1, 10, 2, 1, 128), (1, 10, 2, 300, 128),
                                   (2, 4, 1, 100, 64), (1, 5, 1, 1, 64),
                                   (1, 20, 4, 300, 64), (1, 40, 8, 100, 128)):
                yield from flash_case(b, h, s, d, dtype, causal, False, kv)
        # cross-attention (seamless-m4t-large-v2: 16 heads of 64 over 1024
        # encoder frames, not causal), then Sq != Sk at the edges: one
        # query, ragged lengths, more queries than keys, GQA, D = 128
        for s in (128, 512, 2048):
            yield from flash_case(1, 16, s, 64, dtype, False, True, sk=1024)
        for b, h, kv, s, d, sk in ((1, 16, 16, 1, 64, 1024),
                                   (1, 4, 4, 77, 64, 203),
                                   (2, 4, 4, 300, 64, 100),
                                   (1, 8, 2, 77, 128, 203),
                                   (2, 6, 3, 129, 32, 1),
                                   (1, 4, 4, 1, 128, 1)):
            yield from flash_case(b, h, s, d, dtype, False, False, kv, sk)
        # qwen2-vl-72b's prefill: 64 query heads on 8 KV heads of 128 (G = 8)
        yield from flash_case(1, 64, 2048, 128, dtype, True, True, kv=8)
        # sliding windows (Zamba2's prefill past attn_window)
        for b, h, kv, d in K6_WINDOW_SHAPES:
            for s in K6_WINDOW_SEQS:
                for w in K6_WINDOWS:
                    yield from flash_case(b, h, s, d, dtype, True, True, kv,
                                          window=w)
        # one 128-token chunk, then the 512/1024/2048-token prompt buckets
        for bc in (1, 4, 8, 16):
            yield from ssd_case(bc, 128, 64, 64, 64, dtype, True, True)
        # mamba2-2.7b's 512/1024/2048-token prefills: 80 heads, N = 128
        for bc in (4, 8, 16):
            yield from ssd_case(bc, 128, 80, 64, 128, dtype, True, True)
        for shape in ((2, 16, 8, 8, 4), (1, 32, 4, 16, 8), (3, 8, 16, 8, 16)):
            yield from ssd_case(*shape, dtype, False, False)
            yield from ssd_case(*shape, dtype, True, False)
        # N > 64 at the edges: ragged chunk, N = 96, per-head B/C, P < 64
        for shape in ((2, 100, 8, 64, 128), (3, 128, 4, 64, 96),
                      (2, 77, 6, 32, 128), (1, 128, 3, 64, 72),
                      (1, 64, 2, 30, 90)):
            yield from ssd_case(*shape, dtype, False, False)
            yield from ssd_case(*shape, dtype, True, False)


def lm_compare(torch, case: LMCase, outs, wants) -> tuple[bool, float, str]:
    """(ok, max abs error, criterion) of a call's outputs against its plain
    version's: _close() for y and o; K7's fp32 state and decay from bf16
    inputs within K7_BF16_STATE_RTOL of their largest value."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    wants = wants if isinstance(wants, tuple) else (wants,)
    ok, worst, crit = True, 0.0, ""
    fp32_rtol = K6_FP32_RTOL if case.name == "flash_attention" else K7_FP32_RTOL
    for i, (o, w) in enumerate(zip(outs, wants)):
        if i > 0 and o.dtype == torch.float32 and outs[0].dtype == torch.bfloat16:
            a, r = errors(o, w)
            good, c = r <= K7_BF16_STATE_RTOL, f"rel<={K7_BF16_STATE_RTOL:g}"
        else:
            good, a, c = _close(torch, o, w, fp32_rtol, case.slack)
        ok, worst = ok and good, max(worst, a)
        crit = crit or c
    return ok, worst, crit


def k7_sweep_line(torch, case: LMCase, wants) -> str:
    """Device ms of K7 at every heads-per-block choice of ``case.choices``,
    each held to the plain version's outputs ``wants`` and run twice
    bit-identical; the plan's choice and the fastest are named."""
    times = {}
    for heads in case.choices:
        out = case.forced(heads)
        torch.cuda.synchronize()
        ok, _, crit = lm_compare(torch, case, out, wants)
        same = all(torch.equal(a, b) for a, b in zip(out, case.forced(heads)))
        check(ok and same, f"ssd_chunk {case.label} at {heads} heads a block: "
                           f"{crit}{'' if same else ', repeats differ'}")
        times[heads] = device_ms(lambda h=heads: case.forced(h), iters=5)
    best = min(times, key=times.get)
    cells = " ".join(f"{h} {ms:.5f}" for h, ms in times.items())
    return (f"    sweep heads/block device ms: {cells} | plan {case.plan} "
            f"{times[case.plan]:.5f}, fastest {best} {times[best]:.5f}; every "
            f"choice within the bars, repeats bit-identical")


def run_lm_kernel_phase(torch, dev) -> dict:
    from repro_torch.kernels import cost as kcost

    gen = torch.Generator(device=dev).manual_seed(7)
    summary = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                      "library_ms": None, "bound_ms": None, "bound_by": None,
                      "shapes": [], "paths": {}}
               for name in LM_KERNELS}
    summary["flash_attention"]["windowed"] = []
    for case in lm_kernel_cases(torch, dev, gen):
        name, label = case.name, case.label
        outs, wants = case.kern(), case.plain()
        torch.cuda.synchronize()
        ok, worst, crit = lm_compare(torch, case, outs, wants)
        if case.exact is not None:
            same = torch.equal(outs, case.exact())
            ok, crit = ok and same, crit + (", = v" if same else ", != v")
        fp32 = case.plain64 is not None
        if fp32 and case.timed:
            # the float64 witness (phase 7's backwards' F64_WITNESS): each
            # output's distance to the plain version run in float64
            outs_t = outs if isinstance(outs, tuple) else (outs,)
            wants_t = wants if isinstance(wants, tuple) else (wants,)
            want64 = case.plain64()
            want64 = want64 if isinstance(want64, tuple) else (want64,)
            names = (("o",) if name == "flash_attention"
                     else ("y", "state", "decay"))
            good, note = f64_witness(names, outs_t, wants_t, want64)
            ok, crit = ok and good, f"{crit}; {note}"
            del want64
        if name == "flash_attention":
            label += (" [tensor-core bf16]" if outs.dtype == torch.bfloat16
                      else " [3xTF32 fp32]")
        line = (f"{name:15s} {label:58s} max_abs {worst:.3e} ({crit}) "
                f"{'ok' if ok else 'FAIL'}")
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], worst)
        if case.timed:
            kern, plain, lib = case.kern, case.plain, case.lib
            ms, plain_ms = device_ms(kern, iters=5), device_ms(plain, iters=5)
            lib_ms = device_ms(lib, iters=5) if lib is not None else None
            b_ms, b_by = bound(case.cost)
            flops = sum(case.cost.flops.values())
            line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                     f"library {'none' if lib_ms is None else f'{lib_ms:.5f}'}"
                     f" bound {b_ms:.5f} ({b_by}) = {100 * b_ms / ms:.1f}% | "
                     f"{flops / ms / 1e9:.2f} TFLOP/s, "
                     f"{case.cost.nbytes / ms / 1e6:.1f} GB/s")
            if fp32:
                # the CUDA-core bound the fp32 rows were held to before
                # their 3xTF32 kernels: one fp32 product a product
                cc_ms = max(flops / kcost.TF32_SPLIT
                            / h100().flop_rate("float32") * 1e3,
                            case.cost.nbytes / h100().hbm_bw * 1e3)
                line += f" | CUDA-core bound {cc_ms:.5f}"
            if case.on_path:
                line += (f" [{case.on_path} "
                         f"{'serving path' if not fp32 else 'shape, fp32'}]")
            if case.forced is not None:
                ops_s, bytes_s = case.cost.seconds(h100())
                line += (f" | bound by bytes {bytes_s * 1e3:.5f}, by "
                         f"{'tf32' if fp32 else 'bf16'} ops "
                         f"{ops_s * 1e3:.5f} | plan {case.plan} heads/block")
            if case.window:
                summary[name]["windowed"].append(dict(
                    shape=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=worst))
            if case.on_path:
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, shapes=[label])
                key = f"{case.on_path} float32" if fp32 else case.on_path
                summary[name]["paths"][key] = row
                if case.on_path == ARCH and not fp32:
                    summary[name].update(row)
        print(line, flush=True)
        check(ok, f"{name} {label} disagrees with its plain version")
        if case.forced is not None:
            print(k7_sweep_line(torch, case, wants), flush=True)
    return summary


# ------------------------------------------------------ phase 7: K6 bwd

# K6's backward against its plain version (``ref.flash_attention_bwd_ref``,
# the reference's _sdpa_chunked_bwd arithmetic) on the same q, k, v, dO and
# the kernel's own o and lse.  fp32: each gradient within K6_BWD_FP32_RTOL
# of its largest element (fp32 sums of up to G·Sq terms in another order).
# bf16: each (b, head) slice of dQ, dK and dV element-wise within
# BF16_ULP·|plain| + K6_BWD_SLACK of the slice's largest |plain| (both
# sides round an fp32 sum taken in another order, and dS, rounded to bf16
# on both sides, can flip a rounding) and norm-wise within BF16_ULP; dV
# also ``rounded_once`` at the timed shapes (p stays fp32 for dV, carried
# into wgmma as bf16 hi + lo; p rounded once to bf16 would flip ~40% of
# dV's roundings, tests/test_torch_flash_bwd.py).  Not at the edges: where
# a dV element sums a few exact bf16 products (a window of 1, p = 1) its
# fp32 sum can sit on a rounding tie, and the kernel's p = 1 − 2^-24 (its
# exponent in log2 units) flips the tie: 6.6% of dV at window 1, each by
# one ulp.  Each bar's absolute part is at least
# the fp32 noise of one summed term (``k6_bwd_noise``): where a gradient
# is 0 in exact arithmetic (one key for every query: p = 1 and dP =
# delta, so dQ = dK = 0), both sides return rounding noise of that size.
# The forward's lse within K6_LSE_TOL·(1 + |plain|), and its o with the
# lse bit-identical to o without it.
K6_BWD_FP32_RTOL = 1e-4
K6_BWD_SLACK = 1e-3
K6_BWD_NOISE = 2.0 ** -20     # 16 fp32 ulps of a term's bound
K6_LSE_TOL = 1e-5
# (B, H, KV, S, D, Sk, causal, window), each timed with its forward: the
# attention that phase 18 trains (granite-3-2b: 32 heads on 8 KV heads of
# 64 at 2048 tokens; Zamba2-1.2B's shared attention, 32 heads of 64),
# qwen3-14b's GQA of 128 (1, 40, 2048, 128) on 8, the seamless-m4t-large-v2
# decoder's cross-attention (512 tokens over 1024 frames), a sliding
# window, and what phases 18d-18f train: granite-moe-1b-a400m's 16 heads
# on 8 KV heads of 64 at 2048 tokens (causal), seamless's encoder
# self-attention and cross-attention at the train inputs' 1024 frames and
# tokens (full) and its decoder self-attention (causal), qwen2-vl-72b's
# (1, 64, 2048, 128) on 8 (causal)
K6_BWD_SHAPES = (("granite-3-2b train", (1, 32, 8, 2048, 64, 2048, True, 0)),
                 ("zamba2-1.2b train", (1, 32, 32, 2048, 64, 2048, True, 0)),
                 ("qwen3-14b", (1, 40, 8, 2048, 128, 2048, True, 0)),
                 ("seamless-m4t-large-v2 cross-attention",
                  (1, 16, 16, 512, 64, 1024, False, 0)),
                 ("window 1000", (1, 32, 32, 4096, 64, 4096, True, 1000)),
                 ("granite-moe-1b-a400m train",
                  (1, 16, 8, 2048, 64, 2048, True, 0)),
                 ("seamless-m4t-large-v2 train",
                  (1, 16, 16, 1024, 64, 1024, False, 0)),
                 ("seamless-m4t-large-v2 decoder train",
                  (1, 16, 16, 1024, 64, 1024, True, 0)),
                 ("qwen2-vl-72b train", (1, 64, 8, 2048, 128, 2048, True, 0)))
# the edges, untimed: one token, ragged tiles and lengths, Sk < one tile,
# D = 16, 32, 96, groups of 1 to 5, windows of 1 and 65
K6_BWD_EDGES = ((1, 4, 2, 1, 64, 1, True, 0), (2, 4, 2, 300, 64, 300, True, 0),
                (1, 8, 2, 77, 128, 203, False, 0), (1, 4, 2, 128, 16, 128, True, 0),
                (2, 6, 3, 129, 32, 1, False, 0), (1, 5, 1, 100, 128, 100, True, 0),
                (1, 4, 2, 300, 64, 300, True, 65), (1, 4, 4, 77, 16, 30, False, 0),
                (2, 2, 1, 200, 96, 200, True, 1))
K6_BWD_MAIN = "granite-3-2b train"   # the kernels line's shape
# the products the kernels issue for the five the bound counts: bf16 S,
# dP, dV's hi and lo, dK and dQ; fp32 the five, each as the three TF32
# products the bound already counts (kernels/cost.py)
K6_BWD_ISSUED = {"bfloat16": 6 / 5, "float32": 1.0}
# the fp32 backwards' float64 witness: at each timed shape the plain
# version also runs in float64 on the same inputs, and each gradient's
# distance to it, ||g − g64|| / ||g64||, may be at most F64_WITNESS times
# the fp32 plain version's (3xTF32 keeps about fp32's bits; one TF32
# product, 11 bits, lands ~2^13 times as far)
F64_WITNESS = 8.0


def f64_witness(names, got, want, want64) -> tuple[bool, str]:
    """(ok, a note): each gradient's distance to the float64 run, the
    kernel's (``got``) against the fp32 plain version's (``want``)."""
    ok, parts = True, []
    for name, g, w, w64 in zip(names, got, want, want64):
        n64 = w64.norm().item()
        dk = (g.double() - w64).norm().item() / max(n64, 1e-300)
        dp = (w.double() - w64).norm().item() / max(n64, 1e-300)
        ok = ok and dk <= F64_WITNESS * dp
        parts.append(f"{name} {dk:.2e} vs {dp:.2e} "
                     f"({dk / max(dp, 1e-300):.2f}x)")
    return ok, (f"float64 witness, kernel vs fp32 plain: " + ", ".join(parts)
                + f" (<= {F64_WITNESS:g}x)")


def k6_bwd_noise(q, k, v, do) -> tuple[float, float, float]:
    """The fp32 noise floors of dQ, dK and dV: K6_BWD_NOISE times the bound
    of one term of each sum.  p <= 1 and |dP|, |delta| <= D·max|dO|·max|v|
    (o is a convex combination of v's rows), so |dS| <= 2·√D·max|dO|·max|v|;
    a dQ term is at most that times max|k|, a dK term times max|q|, a dV
    term max|dO|."""
    def big(t):
        return t.float().abs().max().item()

    ds = 2 * q.shape[-1] ** 0.5 * big(do) * big(v)
    return tuple(K6_BWD_NOISE * t for t in (ds * big(k), ds * big(q), big(do)))


def k6_bwd_close(torch, out, want, noise: float = 0.0
                 ) -> tuple[bool, float, str]:
    """(ok, max abs error, the margin) of one gradient of K6's backward
    against its plain version (the bars above); ``noise`` is its
    ``k6_bwd_noise`` floor."""
    check(out.dtype == want.dtype and out.shape == want.shape,
          f"gradient {out.dtype} {tuple(out.shape)} against the plain "
          f"version's {want.dtype} {tuple(want.shape)}")
    a, _ = errors(out, want)
    if out.dtype != torch.bfloat16:
        bar = K6_BWD_FP32_RTOL * want.double().abs().max().item() + noise
        return a <= bar, a, f"{a / max(bar, 1e-300):.2f} of the bar"
    o, w = out.double().flatten(2), want.double().flatten(2)
    slack = (K6_BWD_SLACK * w.abs().amax(-1, keepdim=True)).clamp_min(noise)
    bar = BF16_ULP * w.abs() + slack
    worst = ((o - w).abs() / bar.clamp_min(2.2250738585072014e-308)).max()
    d_norm = (o - w).norm(dim=-1)
    n_bar = BF16_ULP * w.norm(dim=-1) + noise * w.shape[-1] ** 0.5
    norm = (d_norm / n_bar.clamp_min(1e-300)).max()
    return (worst.item() <= 1 and norm.item() <= 1, a,
            f"{worst.item():.2f} of the bar, {norm.item():.2f} of the norm's")


def k6_bwd_inputs(torch, dev, gen, shape, dtype):
    """q, k, v, dO of one case in the model's layout ((B, S, heads, D)
    projections seen as (B, heads, S, D)), and the kernel's o and lse."""
    from repro_torch.kernels.flash_attention import flash_attention

    b, h, kv, s, d, sk, causal, window = shape

    def rand(*size):
        return torch.randn(*size, generator=gen, device=dev).to(dtype)

    q, do = (rand(b, s, h, d).transpose(1, 2) for _ in range(2))
    k, v = (rand(b, sk, kv, d).transpose(1, 2) for _ in range(2))
    o, lse = flash_attention(q, k, v, causal, window, lse=True)
    return q, k, v, do, o, lse


def k6_bwd_library(torch, q, k, v, do, causal: bool, window: int):
    """(forward, forward + backward) of PyTorch's SDPA at the same inputs
    (``is_causal``, or the window's boolean mask, ``enable_gqa``): timed
    only, never on a path."""
    from repro_torch.kernels import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = {"enable_gqa": k.shape[1] != q.shape[1]}
    if window:
        kw["attn_mask"] = ref.attention_mask(q.shape[2], k.shape[2], window,
                                             q.device)
    else:
        kw["is_causal"] = causal
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def fwd():
        with torch.no_grad():
            return sdpa(q, k, v, **kw)

    def both():
        torch.autograd.grad(sdpa(*leaves, **kw), leaves, do)

    return fwd, both


def library_backward_ms(fwd, both) -> float:
    """SDPA's backward alone: forward + backward less forward, each by
    CUDA-graph replay (``device_ms``; autograd's backward is captured with
    the forward)."""
    return (device_ms(both, iters=5, replays=5)
            - device_ms(fwd, iters=5, replays=5))


def run_k6_bwd_phase(torch, dev) -> dict:
    """Phase 7's K6 backward (see the bars above): every case in bf16 and
    fp32, repeats bit-identical; the timed cases against the plain
    version, SDPA's backward (``library_backward_ms``) and the bound.  Returns the kernels line's
    numbers, at K6_BWD_MAIN in bf16, and each timed shape's under
    "paths"."""
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=dev).manual_seed(11)
    summary = {"max_abs_err": 0.0, "paths": {}}
    print(f"K6 backward against its plain version: fp32 each gradient within "
          f"{K6_BWD_FP32_RTOL:g} of its largest; bf16 each (b, head) slice "
          f"element-wise within 2^-7|ref| + {K6_BWD_SLACK:g} of its largest "
          f"and norm-wise within 2^-7 (the share of each bar used), each "
          f"absolute part at least {K6_BWD_NOISE:g} of a summed term's bound;"
          f" dV also rounded once (one ulp + {ONCE_SLACK:g} of the largest, "
          f"at most {ONCE_MISS:g} of the roundings flipped); lse within "
          f"{K6_LSE_TOL:g}(1 + |ref|)", flush=True)
    cases = [(name, shape) for name, shape in K6_BWD_SHAPES]
    cases += [("", shape) for shape in K6_BWD_EDGES]
    for name, shape in cases:
        for dtype in (torch.bfloat16, torch.float32):
            b, h, kv, s, d, sk, causal, window = shape
            q, k, v, do, o, lse = k6_bwd_inputs(torch, dev, gen, shape, dtype)
            same_o = torch.equal(o, flash_attention(q, k, v, causal, window))
            lse_ref = ref.flash_attention_lse_ref(q, k, v, causal, window)[1]
            lse_err = ((lse - lse_ref).abs() / (1 + lse_ref.abs())).max().item()

            def kern():
                return flash_attention_bwd(q, k, v, o, do, lse, causal, window)

            got, again = kern(), kern()
            want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal,
                                               window)
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            ok, worst, crits = same_o and lse_err <= K6_LSE_TOL and repeat, 0.0, []
            for gname, g, w, noise in zip(("dq", "dk", "dv"), got, want,
                                          k6_bwd_noise(q, k, v, do)):
                good, a, crit = k6_bwd_close(torch, g, w, noise)
                ok, worst = ok and good, max(worst, a)
                crits.append(f"{gname} {crit}")
            if dtype == torch.bfloat16 and name:
                good, note = rounded_once(torch, got[2], want[2])
                ok = ok and good
                crits.append(f"dv {note.split(', ', 1)[1]}")
            if dtype == torch.float32 and name:
                want64 = ref.flash_attention_bwd_ref(
                    *(t.double() for t in (q, k, v, o, do, lse)), causal,
                    window)
                good, note = f64_witness(("dq", "dk", "dv"), got, want,
                                         want64)
                ok = ok and good
                crits.append(note)
                del want64
            label = (f"({b},{h},{s},{d}) kv {kv}{f' over Sk {sk}' if sk != s else ''} "
                     f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
                     f"{f' window {window}' if window else ''}")
            line = (f"flash_attention_bwd {label:48s} max_abs {worst:.3e} "
                    f"({'; '.join(crits)}; lse {lse_err:.1e}; o with lse "
                    f"{'=' if same_o else '!='} o; repeats "
                    f"{'bit-identical' if repeat else 'DIFFER'}) "
                    f"{'ok' if ok else 'FAIL'}")
            summary["max_abs_err"] = max(summary["max_abs_err"], worst)
            if name:
                del again, want
                fwd, both = k6_bwd_library(torch, q, k, v, do, causal, window)
                # the forward with its lse, as a train step runs it: held
                # to the plain version at phase 7's K6 bars, timed beside
                # it, SDPA's forward and the bound
                f_want = ref.flash_attention_ref(q, k, v, causal, window)
                f_ok, f_err, f_crit = _close(
                    torch, o, f_want,
                    K6_FP32_RTOL, lambda: BF16_ULP * ref.flash_attention_ref(
                        q.float(), k.float(), v.float().abs(), causal,
                        window))
                if dtype == torch.float32:   # the forward's float64 witness
                    good, note = f64_witness(("o",), (o,), (f_want,), (
                        ref.flash_attention_ref(q.double(), k.double(),
                                                v.double(), causal, window),))
                    f_ok, f_crit = f_ok and good, f"{f_crit}; {note}"
                del f_want
                ok = ok and f_ok
                f_ms = device_ms(lambda: flash_attention(
                    q, k, v, causal, window, lse=True), iters=5, replays=5)
                f_plain = device_ms(lambda: ref.flash_attention_lse_ref(
                    q, k, v, causal, window), iters=2, replays=3)
                f_lib = device_ms(fwd, iters=5, replays=5)
                f_bound, f_by = bound(kcost.flash_attention(
                    b, h, kv, s, sk, d, q.element_size(), causal, window))
                ms = device_ms(kern, iters=5, replays=5)
                plain_ms = device_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, o, do, lse, causal, window), iters=2, replays=3)
                lib_ms = library_backward_ms(fwd, both)
                c = kcost.flash_attention_bwd(b, h, kv, s, sk, d,
                                              q.element_size(), causal, window)
                b_ms, b_by = bound(c)
                flops = sum(c.flops.values())
                issued = flops * K6_BWD_ISSUED[str(dtype)[6:]]
                line += (f" | device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
                         f"library (SDPA backward) {lib_ms:.5f} bound "
                         f"{b_ms:.5f} ({b_by}) = {100 * b_ms / ms:.1f}% | "
                         f"{flops / ms / 1e9:.2f} TFLOP/s of work, "
                         f"{issued / ms / 1e9:.2f} issued [{name}]"
                         f"\n  its forward with the lse: max_abs {f_err:.3e} "
                         f"({f_crit}) {'ok' if f_ok else 'FAIL'} | device ms:"
                         f" kernel {f_ms:.5f} plain {f_plain:.5f} library "
                         f"(SDPA forward) {f_lib:.5f} bound {f_bound:.5f} "
                         f"({f_by}) = {100 * f_bound / f_ms:.1f}%")
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, shapes=[label],
                           max_abs_err=worst, forward={
                               "ms": f_ms, "plain_ms": f_plain,
                               "library_ms": f_lib, "bound_ms": f_bound,
                               "bound_by": f_by, "max_abs_err": f_err})
                summary["paths"][f"{name} {str(dtype)[6:]}"] = row
                if name == K6_BWD_MAIN and dtype == torch.bfloat16:
                    summary.update({k_: v_ for k_, v_ in row.items()
                                    if k_ not in ("max_abs_err", "forward")})
            print(line, flush=True)
            check(ok, f"flash_attention_bwd {label} disagrees with its plain "
                      f"version")
            del q, k, v, do, o, lse, got
    free_device_memory(torch)
    return summary


# ------------------------------------------------------ phase 7: K7 bwd

# (label, (BC, Q, H, P, N, G), timed): the SSD that phase 18 trains
# (K7_PATHS: Zamba2-1.2B's and mamba2-2.7b's 2048-token sequence, one B/C
# group), then per-head and grouped B/C, a ragged chunk, Q <= 64, N = 72
# and 90, P < 64
K7_BWD_SHAPES = (tuple((f"{arch} train", (*K7_PATHS[arch], 1), True)
                       for arch in (ARCH, SSM_ARCH))
                 + (("", (2, 100, 8, 64, 128, 8), False),
                    ("", (3, 77, 6, 32, 72, 3), False),
                    ("", (1, 128, 3, 64, 90, 3), False),
                    ("", (2, 64, 4, 16, 16, 1), False),
                    ("", (2, 16, 8, 8, 4, 2), False)))
K7_BWD_MAIN = f"{ARCH} train"   # the kernels line's shape
# the cotangents a case passes (the others None: zero), every subset of
# one or all three: the kernel stages a missing one as zeros
K7_BWD_COTANGENTS = ((True, True, True), (True, False, False),
                     (False, True, False), (False, False, True))


def k7_bwd_inputs(torch, dev, gen, shape, dtype):
    """x, dt_a, b, c (B and C one of G groups broadcast to its H / G
    consecutive heads, a stride-0 view where G = 1, as the model hands K7
    them) and the cotangents dy, dstate, ddecay of one case; dt_a = −0.3·|N|
    as phase 7's K7 cases."""
    from repro_torch.kernels.ops import heads_of_groups

    bc, q, h, p, n, g = shape

    def rand(*size, dt=torch.float32):
        return torch.randn(*size, generator=gen, device=dev).to(dt)

    x, dy = rand(bc, q, h, p, dt=dtype), rand(bc, q, h, p, dt=dtype)
    dt_a = -rand(bc, q, h).abs() * 0.3
    b, c = (heads_of_groups(rand(bc, q, g, n, dt=dtype), h) for _ in range(2))
    return x, dt_a, b, c, dy, rand(bc, h, p, n), rand(bc, q, h)


def k7_bwd_noise(x, b, c, dy, dstate, ddecay) -> float:
    """The fp32 noise floor of d(dt_a): K7_BWD_NOISE times the largest bound
    of one summed term.  By Cauchy-Schwarz over the rows, |(dS∘S)[t,s]| <=
    ||dy_t||·||x_s||·||C_t||·||B_s||, |dw_s·w_s| <= ||x_s||·||dst||·||B_s||
    (w <= 1), |ddec_t·exp(cs_t)| <= |ddec_t|; a missing cotangent adds
    nothing."""
    def rows(t):
        return t.float().norm(dim=-1).max().item()

    xb = rows(x) * rows(b)
    terms = [0.0]
    if dy is not None:
        terms.append(rows(dy) * rows(c) * xb)
    if dstate is not None:
        terms.append(dstate.float().flatten(2).norm(dim=-1).max().item() * xb)
    if ddecay is not None:
        terms.append(ddecay.float().abs().max().item())
    return K7_BWD_NOISE * max(terms)


def k7_bwd_close(torch, got, want, noise: float) -> tuple[bool, float, str]:
    """(ok, max abs error, the margins) of K7's backward (dx, d(dt_a), dB,
    dC) against its plain version: the bars above; ``noise`` is the
    ``k7_bwd_noise`` floor of d(dt_a)."""
    ok, worst, crits = True, 0.0, []
    for name, g, w in zip(("dx", "ddt", "db", "dc"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name} {g.dtype} {tuple(g.shape)} against the plain "
              f"version's {w.dtype} {tuple(w.shape)}")
        a, _ = errors(g, w)
        big = w.double().abs().max().item()
        if name == "ddt":
            bar = K7_BWD_DT_RTOL * big + noise
            good, crit = a <= bar, f"{a / max(bar, 1e-300):.2f} of the bar"
        elif g.dtype == torch.bfloat16:
            good, crit = rounded_once(torch, g, w)
            crit = crit.split(": ", 1)[1]
        else:
            bar = K7_BWD_FP32_RTOL * big
            good = a <= bar
            crit = f"{a / max(bar, 1e-300):.2f} of the bar"
        ok, worst = ok and good, max(worst, a)
        crits.append(f"{name} {crit}")
    return ok, worst, "; ".join(crits)


def k7_bwd_sweep_line(torch, ssd_chunk_bwd, x, dt_a, b, c, use, g,
                      want) -> str:
    """Device ms of K7 bwd in x's dtype at every heads-per-block choice of
    ssd_scan.SSD_BWD_HEADS that divides H / G, each held to the plain
    version's gradients ``want`` at the bars above and run twice
    bit-identical; the plan's choice and the fastest are named."""
    from repro_torch.kernels.ssd_scan import SSD_BWD_HEADS, ssd_bwd_plan

    bc, q, h, _ = x.shape
    noise = k7_bwd_noise(x, b, c, *use)
    times = {}
    for heads in (k for k in SSD_BWD_HEADS if (h // g) % k == 0):
        def kern(heads=heads):
            return ssd_chunk_bwd(x, dt_a, b, c, *use, g, heads=heads)

        out, again = kern(), kern()
        torch.cuda.synchronize()
        ok, _, crit = k7_bwd_close(torch, out, want, noise)
        same = all(torch.equal(u, v) for u, v in zip(out, again))
        check(ok and same, f"ssd_chunk_bwd at {heads} heads a block: {crit}"
                           f"{'' if same else ', repeats differ'}")
        del out, again
        times[heads] = device_ms(kern, iters=5, replays=5)
    plan = ssd_bwd_plan(bc, h, q, g, b.shape[-1])
    best = min(times, key=times.get)
    cells = " ".join(f"{k} {ms:.5f}" for k, ms in times.items())
    return (f"    sweep heads/block device ms: {cells} | plan {plan} "
            f"{times[plan]:.5f}, fastest {best} {times[best]:.5f}; every "
            f"choice within the bars, repeats bit-identical")


def run_k7_bwd_phase(torch, dev) -> dict:
    """Phase 7's K7 backward (the bars above): every case in bf16 and fp32
    with every set of cotangents of K7_BWD_COTANGENTS, repeats
    bit-identical; the timed cases (all three cotangents) against the plain
    version and the bound.  Returns the kernels line's numbers, at
    K7_BWD_MAIN in bf16, and each timed shape's under "paths"."""
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd

    gen = torch.Generator(device=dev).manual_seed(13)
    summary = {"max_abs_err": 0.0, "paths": {}}
    print(f"K7 backward against its plain version: dx, dB, dC fp32 within "
          f"{K7_BWD_FP32_RTOL:g} of their largest, bf16 rounded once (one "
          f"ulp + {ONCE_SLACK:g} of the largest, at most {ONCE_MISS:g} of "
          f"the roundings flipped); d(dt_a) within {K7_BWD_DT_RTOL:g} of its "
          f"largest + {K7_BWD_NOISE:g} of a summed term's bound (the share "
          f"of each bar used)", flush=True)
    for name, shape, timed in K7_BWD_SHAPES:
        bc, q, h, p, n, g = shape
        for dtype in (torch.bfloat16, torch.float32):
            x, dt_a, b, c, *cots = k7_bwd_inputs(torch, dev, gen, shape, dtype)
            for given in K7_BWD_COTANGENTS:
                use = [t if k else None for t, k in zip(cots, given)]

                def kern(use=use):
                    return ssd_chunk_bwd(x, dt_a, b, c, *use, g)

                got, again = kern(), kern()
                want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, *use, g)
                torch.cuda.synchronize()
                repeat = all(torch.equal(u, v) for u, v in zip(got, again))
                ok, worst, crit = k7_bwd_close(torch, got, want,
                                               k7_bwd_noise(x, b, c, *use))
                ok = ok and repeat
                if timed and all(given) and dtype == torch.float32:
                    want64 = ref.ssd_chunk_bwd_ref(
                        *(t.double() for t in (x, dt_a, b, c, *use)), g)
                    good, note = f64_witness(("dx", "ddt", "db", "dc"), got,
                                             want, want64)
                    ok, crit = ok and good, f"{crit}; {note}"
                    del want64
                given_bits = "".join("1" if k else "0" for k in given)
                label = (f"BC={bc} ({q},{h},{p},{n}) G={g} {str(dtype)[6:]} "
                         f"cotangents {given_bits}")
                line = (f"ssd_chunk_bwd {label:48s} max_abs {worst:.3e} "
                        f"({crit}; repeats "
                        f"{'bit-identical' if repeat else 'DIFFER'}) "
                        f"{'ok' if ok else 'FAIL'}")
                summary["max_abs_err"] = max(summary["max_abs_err"], worst)
                if timed and all(given):
                    print(k7_bwd_sweep_line(torch, ssd_chunk_bwd, x, dt_a, b,
                                            c, use, g, want), flush=True)
                    del again, want
                    ms = device_ms(kern, iters=5, replays=5)
                    plain_ms = device_ms(lambda: ref.ssd_chunk_bwd_ref(
                        x, dt_a, b, c, *use, g), iters=2, replays=3)
                    cost = kcost.ssd_chunk_bwd(bc, q, h, p, n, g,
                                               x.element_size())
                    b_ms, b_by = bound(cost)
                    ops_s, bytes_s = cost.seconds(h100())
                    flops = sum(cost.flops.values())
                    line += (f" | device ms: kernel {ms:.5f} plain "
                             f"{plain_ms:.5f} library none bound {b_ms:.5f} "
                             f"({b_by}; bytes {bytes_s * 1e3:.5f}, operations "
                             f"{ops_s * 1e3:.5f}) = {100 * b_ms / ms:.1f}% | "
                             f"{flops / ms / 1e9:.2f} TFLOP/s, "
                             f"{cost.nbytes / ms / 1e6:.1f} GB/s [{name}]")
                    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by, shapes=[label],
                               max_abs_err=worst)
                    summary["paths"][f"{name} {str(dtype)[6:]}"] = row
                    if name == K7_BWD_MAIN and dtype == torch.bfloat16:
                        summary.update({k: v for k, v in row.items()
                                        if k != "max_abs_err"})
                print(line, flush=True)
                check(ok, f"ssd_chunk_bwd {label} disagrees with its plain "
                          f"version")
                del got
            del x, dt_a, b, c, cots
    free_device_memory(torch)
    return summary


# --------------------------------------------------------------- phase 8


def launches_per_prefill(cfg) -> dict[str, int]:
    """K6 and K7 launches of one prefill: the hybrid's shared-attention
    invocations and Mamba layers; one K7 per layer of the Mamba2 LM; one K6
    per encoder layer and two per decoder layer (self- and
    cross-attention) of the encoder-decoder; one K6 per layer of a dense,
    MoE or VLM stack."""
    from repro_torch.models.zamba2 import n_shared_invocations

    if cfg.family == "hybrid":
        return {"flash_attention": n_shared_invocations(cfg),
                "ssd_chunk": cfg.n_layers}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_chunk": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers,
                "ssd_chunk": 0}
    return {"flash_attention": cfg.n_layers, "ssd_chunk": 0}


def free_device_memory(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def run_serve_phase(torch, dev, arch: str = ARCH,
                    n_requests: int = 8) -> dict[str, int]:
    """Serve ``arch`` at full width through the port's entry point; return
    the LM kernels' launch counts of that run (counters reset just
    before)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report_lines, serve
    from repro_torch.serve import WallClock

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    result = serve(arch, scenario="steady", n_requests=n_requests,
                   prompt_buckets=SERVE_BUCKETS, slots=4, seed=0, device=dev,
                   clock=WallClock())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    cfg, sc = result.cfg, result.scenario
    for line in report_lines(result, 0, 4):
        print(line)
    n_prefill = result.n_prefills + len(sc.prompt_buckets)   # + warmup
    per = launches_per_prefill(cfg)
    print(f"prompt buckets {SERVE_BUCKETS}: "
          f"{result.n_prefills} prefills + {len(sc.prompt_buckets)} warmup, "
          f"{result.n_decode_steps} decode steps; wall {wall:.2f} s "
          f"(warmup and weights included)")
    print(f"launches in the serving run: {launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory {peak / 2**30:.3f} GiB = {peak / 1e9:.3f} GB "
          f"(torch.cuda.max_memory_allocated; < 80 GB)")
    check(peak < 80e9, f"peak device memory {peak / 1e9:.3f} GB >= 80 GB")
    check(result.slo.n_finished == sc.n_requests,
          f"served {result.slo.n_finished}/{sc.n_requests} requests")
    for name in LM_KERNELS:
        check(launches[name] == per[name] * n_prefill,
              f"{name} launched {launches[name]} times, expected "
              f"{per[name]} per prefill x {n_prefill}")
        if per[name]:
            check(launches[name] > 0, f"{name} never launched")
    return {name: launches[name] for name in LM_KERNELS}


def run_prefill_profile(torch, dev, model, params, tokens, batch=None,
                        max_len=None, what=None) -> None:
    """Where a 2048-token prefill's time goes: host ms with the profiler
    off, then device time of K6, K7 and everything from torch.profiler.
    ``batch``, ``max_len`` and ``what`` replace the token prompt's batch,
    cache depth and name (the encoder-decoder's and VLM's inputs)."""
    from torch.profiler import ProfilerActivity, profile

    batch = batch or {"tokens": tokens}
    max_len = max_len or tokens.shape[1] + 16
    what = what or f"{tokens.shape[1]}-token prefill"
    reps = 3
    with torch.inference_mode():
        model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch, max_len)
            torch.cuda.synchronize()
    print(f"{what}, profiler off: {host_ms:.3f} ms (mean of {reps})")
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return
    busy = sum(us for _, _, us in rows) / 1e3
    k6 = sum(us for k, _, us in rows if "flash_fwd" in k) / 1e3
    k7 = sum(us for k, _, us in rows if "ssd_chunk" in k) / 1e3
    print(f"device busy {busy:.3f} ms = {100 * busy / host_ms:.1f}% of the "
          f"profiler-off prefill; K6 flash_attention {k6:.3f} ms "
          f"({100 * k6 / busy:.1f}% of busy), K7 ssd_chunk {k7:.3f} ms "
          f"({100 * k7 / busy:.1f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {us / 1e3:9.4f} ms {count:4d} calls  {key[:100]}")


def run_mlp_timing(torch, dev, cfg, params, tokens: int) -> None:
    """The SwiGLU MLP's cost at the prefill shape, before and after it kept
    its gate and up products in fp32: each (tokens, d_model) x (d_model,
    d_ff) GEMM with bf16 output (the earlier form) and with fp32 output
    (``layers.matmul_fp32``), and the whole MLP in both forms; a prefill
    runs the MLP once per shared-block invocation."""
    from repro_torch.models import layers as L
    from repro_torch.models.zamba2 import n_shared_invocations

    p = params["shared"]["mlp"]
    x = torch.randn((1, tokens, cfg.d_model), device=dev).to(torch.bfloat16)
    silu = torch.nn.functional.silu

    def mlp_bf16_products():
        g = torch.matmul(x, p["w_gate"])
        u = torch.matmul(x, p["w_up"])
        h = (silu(g.float()) * u.float()).to(x.dtype)
        return torch.matmul(h, p["w_down"])

    with torch.inference_mode():
        got = L.matmul_fp32(x, p["w_gate"])
        want = torch.matmul(x.float(), p["w_gate"].float())
        check(got.dtype == torch.float32, "matmul_fp32 does not return fp32")
        rel = errors(got, want)[1]
        check(rel <= 1e-5, f"bf16 GEMM with fp32 output is {rel:.3e} from "
                           f"the fp32 product of the upcast operands")
        gemm = {name: device_ms(fn, iters=3) for name, fn in (
            ("bf16 out", lambda: torch.matmul(x, p["w_gate"])),
            ("fp32 out", lambda: L.matmul_fp32(x, p["w_gate"])))}
        whole = {name: device_ms(fn, iters=3) for name, fn in (
            ("bf16 products", mlp_bf16_products),
            ("fp32 products", lambda: L.mlp(p, x)))}
    calls = n_shared_invocations(cfg)
    flops = 2 * tokens * cfg.d_model * cfg.d_ff
    print(f"MLP gate/up GEMM ({tokens}x{cfg.d_model})x({cfg.d_model}x"
          f"{cfg.d_ff}) bf16 operands: bf16 output {gemm['bf16 out']:.4f} ms, "
          f"fp32 output {gemm['fp32 out']:.4f} ms "
          f"({flops / gemm['fp32 out'] / 1e9:.1f} TFLOP/s; {rel:.1e} from "
          f"the fp32 product); x{2 * calls} a prefill: "
          f"{2 * calls * gemm['bf16 out']:.3f} -> "
          f"{2 * calls * gemm['fp32 out']:.3f} ms")
    print(f"MLP whole: g, u rounded to bf16 {whole['bf16 products']:.4f} ms, "
          f"kept fp32 {whole['fp32 products']:.4f} ms; x{calls} a prefill: "
          f"{calls * whole['bf16 products']:.3f} -> "
          f"{calls * whole['fp32 products']:.3f} ms")


def run_decode_profile(torch, dev, model, params, cache=None) -> None:
    """Where a batched decode step's time goes: 4 slots each 2048 tokens
    deep in a cache sized as the serving run's, or the rows of ``cache``
    (a prefill's) at their depth."""
    from torch.profiler import ProfilerActivity, profile

    slots, depth, steps = 4, max(SERVE_BUCKETS), 10
    if cache is None:
        cache = model.init_cache(slots, depth + 16, dev)
        cache["len"].fill_(depth)
    slots, depth = cache["len"].shape[0], int(cache["len"][0])
    batch = {"tokens": torch.zeros((slots, 1), dtype=torch.int64, device=dev)}
    with torch.inference_mode():
        for _ in range(3):
            model.decode_step(params, cache, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cache, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode_step(params, cache, batch)
            torch.cuda.synchronize()
    print(f"decode step, {slots} slots at depth {depth}, profiler off: "
          f"{host_ms:.3f} ms (mean of {steps})")
    rows = device_rows(prof)
    if not rows:
        print("device time: not measured (the profiler recorded no device "
              "events)")
        return
    busy = sum(us for _, _, us in rows) / 1e3 / steps
    n_ops = sum(c for _, c, _ in rows) / steps
    print(f"device busy {busy:.3f} ms/step over {n_ops:.0f} device "
          f"operations/step = {100 * busy / host_ms:.1f}% of the step "
          f"(idle {100 - 100 * busy / host_ms:.1f}%)")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step {count / steps:6.1f} "
              f"calls/step  {key[:90]}")


# --------------------------------------------------------------- phase 9


def run_parity_phase(torch, dev, model_bf16, params_bf16, tokens_2048,
                     arch: str = ARCH, fp32_layers: int | None = None) -> None:
    """``arch``'s kernel path against its plain path: fp32 at full width
    (cut to ``fp32_layers`` layers where given), then bf16 at full depth
    from ``params_bf16``."""
    run_fp32_parity(torch, dev, tokens_2048, arch, fp32_layers)
    # bf16, full width, 2048-token prompt
    with torch.inference_mode():
        batch = {"tokens": tokens_2048}
        lk, _ = model_bf16.prefill(params_bf16, batch, 2064)
        lp, _ = model_bf16.prefill(params_bf16, batch, 2064, mode="ref")
    bf16_logit_check(torch, lk, lp, f"bf16 {tokens_2048.shape[1]}-token "
                                    f"prefill")


def run_fp32_parity(torch, dev, tokens_2048, arch: str,
                    fp32_layers: int | None = None) -> None:
    """``arch`` in fp32 at full width (cut to ``fp32_layers`` layers where
    given): a 512-token prefill and 8 greedy steps, kernel path against
    plain path within 1e-3 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    # fp32, full width, 512-token prompt, then 8 greedy steps
    cfg32 = get_config(arch).replace(dtype="float32", param_dtype="float32")
    if fp32_layers is not None:
        cfg32 = cfg32.replace(n_layers=fp32_layers)
        print(f"fp32 at full width, cut to {fp32_layers} of "
              f"{get_config(arch).n_layers} layers (weights in fp32 would "
              f"not fit beside the bf16 model)")
    m32 = get_model(cfg32)
    with torch.inference_mode():
        p32 = m32.init(torch.Generator(device=dev).manual_seed(1), dev)
        toks = tokens_2048[:, :512]
        lk, ck = m32.prefill(p32, {"tokens": toks}, 528)
        lp, cp = m32.prefill(p32, {"tokens": toks}, 528, mode="ref")
        worst = 0.0
        for step in range(9):
            scale = lp.abs().max().item()
            diff = (lk - lp).abs().max().item()
            worst = max(worst, diff / scale)
            print(f"fp32 {'prefill' if step == 0 else f'decode {step}'}: "
                  f"max |dlogit| {diff:.3e} of max |logit| {scale:.3f} "
                  f"= {diff / scale:.3e} (<= 1e-3)")
            check(diff <= 1e-3 * scale,
                  "fp32 kernel-path logits disagree with the plain path")
            if step == 8:
                break
            tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
            lk, ck = m32.decode_step(p32, ck, {"tokens": tok})
            lp, cp = m32.decode_step(p32, cp, {"tokens": tok})
        for key in sorted(set(ck) - {"len"}):
            a, r = errors(ck[key], cp[key])
            print(f"fp32 cache {key}: max_abs {a:.3e} max_rel {r:.3e}")
    del p32, ck, cp
    free_device_memory(torch)


def bf16_logit_check(torch, lk, lp, what: str, ref_name: str = "plain"
                     ) -> None:
    """bf16 logits ``lk`` of the path under test against reference logits
    ``lp`` (the plain path's, named ``ref_name``): within BF16_LOGIT_RTOL
    of the largest logit, and the greedy token equal where the
    reference's top-2 gap exceeds twice the logit difference."""
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = torch.topk(lp[0, -1], 2).values
    gap = (top2[0] - top2[1]).item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    print(f"{what}: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.3f} = {diff / scale:.3e} (<= {BF16_LOGIT_RTOL:g}); "
          f"{ref_name} top-2 gap {gap:.4e}; greedy token kernel {tk} "
          f"{ref_name} {tp}")
    check(diff <= BF16_LOGIT_RTOL * scale,
          f"bf16 kernel-path logits disagree with the {ref_name} path")
    if gap > 2 * diff:
        check(tk == tp, "bf16 greedy token differs where the top-2 gap "
                        "exceeds twice the logit difference")
    else:
        print("top-2 gap within twice the logit difference: token equality "
              "not required")


def lm_path_phases(torch, dev) -> tuple[dict, dict]:
    """Phases 7-9; returns (phase-7 summary, phase-8 launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    phase(7, "flash attention (K6), SSD chunk (K7) and their backwards "
             "against their plain versions")
    summary = run_lm_kernel_phase(torch, dev)
    summary["flash_attention_bwd"] = run_k6_bwd_phase(torch, dev)
    summary["ssd_chunk_bwd"] = run_k7_bwd_phase(torch, dev)

    phase(8, "serve Zamba2-1.2B, full width, bf16, 8 requests on 4 slots")
    launches = run_serve_phase(torch, dev)
    cfg = get_config(ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_mlp_timing(torch, dev, cfg, params, tokens.shape[1])
    run_decode_profile(torch, dev, model, params)

    phase(9, "full-width parity: kernel path against plain path")
    run_parity_phase(torch, dev, model, params, tokens)
    return summary, launches


# ------------------------------------------------------- phases 12-14

# the fp32 parity of phase 13 runs qwen3-14b at full width cut to this many
# layers: 40 fp32 layers (53 GB) would not fit beside the bf16 model
DENSE_FP32_LAYERS = 4
MOE_PARITY_TOKENS = 512
# the fp32 witness of phase 14 runs qwen2-moe-a2.7b at full width cut to
# this many layers (57 GB in fp32 at full depth)
MOE_FP32_LAYERS = 8


def dense_path_phases(torch, dev) -> dict[str, dict[str, int]]:
    """Phases 12-14: qwen3-14b served at full width, its kernel path
    against its plain path, then qwen2-moe-a2.7b served and held the same
    way; returns each serving run's K6/K7 launch counts by arch."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    phase(12, f"serve {DENSE_ARCH}, full width, bf16, 8 requests on 4 slots")
    launches = {DENSE_ARCH: run_serve_phase(torch, dev, DENSE_ARCH, 8)}
    free_device_memory(torch)
    cfg = get_config(DENSE_ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_decode_profile(torch, dev, model, params)

    phase(13, f"{DENSE_ARCH} parity: kernel path against plain path")
    run_parity_phase(torch, dev, model, params, tokens, arch=DENSE_ARCH,
                     fp32_layers=DENSE_FP32_LAYERS)
    del params
    free_device_memory(torch)

    phase(14, f"serve {MOE_ARCH}, full width, bf16, 4 requests on 4 slots; "
              f"kernel path against plain path")
    launches[MOE_ARCH] = run_serve_phase(torch, dev, MOE_ARCH, 4)
    free_device_memory(torch)
    cfg = get_config(MOE_ARCH)
    run_moe_parity(torch, dev, cfg.replace(dtype="float32",
                                           param_dtype="float32",
                                           n_layers=MOE_FP32_LAYERS))
    run_moe_parity(torch, dev, cfg)
    return launches


class ExpertChoices:
    """The MoE's expert choices, recorded in one run and replayed in
    another, keyed by (layer, pass, n): the layer from its router's place
    in the stacked leaf (layer i's view starts i·numel into it), the pass
    "forward" or "recompute" (a call made while autograd runs a backward
    is the remat's recompute of its layer's forward, which runs the layers
    last first), n the count of earlier calls with the same layer and
    pass (a microbatch, a prefill).  ``record()`` and ``replay()`` are
    context managers that patch ``moe._route`` (to learn the key) and
    ``moe.top_k`` (to pick) and restore both on exit, a raise included; a
    replayed call takes its recorded experts and gathers their gates from
    its own probabilities, and a key that was not recorded raises."""

    FORWARD, RECOMPUTE = "forward", "recompute"

    def __init__(self):
        self.choices: dict[tuple[int, str, int], object] = {}

    @classmethod
    def key(cls, router, seen: dict) -> tuple[int, str, int]:
        import torch

        layer = router.storage_offset() // max(router.numel(), 1)
        kind = (cls.RECOMPUTE if torch._C._current_graph_task_id() != -1
                else cls.FORWARD)
        n = seen.get((layer, kind), 0)
        seen[(layer, kind)] = n + 1
        return layer, kind, n

    @contextlib.contextmanager
    def _patched(self, pick):
        from repro_torch.models import moe

        route, top_k = moe._route, moe.top_k
        seen: dict = {}
        keys: list = []

        def keyed_route(router, tokens, valid, cfg):
            keys.append(self.key(router, seen))
            try:
                return route(router, tokens, valid, cfg)
            finally:
                keys.pop()

        moe._route = keyed_route
        moe.top_k = lambda probs, k: pick(keys[-1], probs, k, top_k)
        try:
            yield self
        finally:
            moe._route, moe.top_k = route, top_k

    def record(self):
        """Record every call's choices (earlier records dropped)."""
        self.choices = {}

        def pick(key, probs, k, top_k):
            gate, expert = top_k(probs, k)
            self.choices[key] = expert
            return gate, expert
        return self._patched(pick)

    def replay(self):
        def pick(key, probs, k, top_k):
            if key not in self.choices:
                raise KeyError(f"no expert choices recorded for {key}")
            expert = self.choices[key]
            return probs.gather(-1, expert), expert
        return self._patched(pick)

    def by_layer(self, kind: str = FORWARD, n: int = 0) -> list:
        """The (G, T, k) choices of each layer's ``kind`` call ``n``."""
        return [self.choices[key] for key in sorted(self.choices)
                if key[1:] == (kind, n)]

    def recompute_differs(self) -> list[tuple[int, int]]:
        """(layer, n) of every recompute whose choices are not bit for bit
        its forward's."""
        import torch

        return [(layer, n) for (layer, kind, n), e in sorted(
                    self.choices.items())
                if kind == self.RECOMPUTE and not torch.equal(
                    e, self.choices[(layer, self.FORWARD, n)])]


def moe_prefills(torch, model, params, batch, max_len: int):
    """Prefill logits of the kernel path, the plain path, and the plain path
    replaying the kernel path's expert choices (``ExpertChoices``; gates
    from its own probabilities); and the experts each free-running path
    chose, a (G, T, k) tensor per layer."""
    kernel, plain = ExpertChoices(), ExpertChoices()
    with kernel.record():
        lk, _ = model.prefill(params, batch, max_len)
    with plain.record():
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
    with kernel.replay():
        lpin, _ = model.prefill(params, batch, max_len, mode="ref")
    return lk, lp, lpin, kernel.by_layer(), plain.by_layer()


def flip_shares(kernel: list, plain: list) -> list[float]:
    """Per layer, the share of tokens whose set of k experts differs
    between the two paths."""
    return [float((a.sort(-1).values != b.sort(-1).values).any(-1)
                  .float().mean()) for a, b in zip(kernel, plain)]


def run_moe_parity(torch, dev, cfg) -> None:
    """The MoE's kernel path against its plain path at MOE_PARITY_TOKENS
    tokens.  Where a token's router probabilities sit within the paths'
    difference at the k-th place, its experts flip and its output moves by
    whole experts; later layers see the moved hidden state, so flips
    cascade.  Printed: the share of tokens whose experts flip, per layer
    (layer 0's differ only through attention, before any flip).  fp32:
    the paths differ by K6's fp32 roundings, so free-running logits are
    held within 1e-3 of the largest.  bf16: the free-running logits and
    greedy token are printed only; the plain path then replays the kernel
    path's choices, which leaves only the roundings, held to the bf16
    logit bar and greedy-token rule."""
    from repro_torch.models.api import get_model

    model = get_model(cfg)
    what = (f"{MOE_ARCH} {cfg.dtype} {MOE_PARITY_TOKENS}-token prefill, "
            f"{cfg.n_layers} layers")
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, dev)
        toks = torch.randint(0, cfg.vocab_size, (1, MOE_PARITY_TOKENS),
                             generator=gen, device=dev)
        lk, lp, lpin, ck, cp = moe_prefills(
            torch, model, params, {"tokens": toks}, MOE_PARITY_TOKENS + 16)
    del params
    free_device_memory(torch)
    shares = flip_shares(ck, cp)
    total = sum(shares) / len(shares)
    print(f"{what}, expert choices that differ between the paths, % of "
          f"tokens by layer: " + " ".join(f"{100 * f:.2f}" for f in shares)
          + f"; all layers {100 * total:.2f}%")
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    if cfg.dtype == "float32":
        print(f"{what}, free-running: max |dlogit| {diff:.3e} of max |logit| "
              f"{scale:.3f} = {diff / scale:.3e} (<= 1e-3); greedy token "
              f"kernel {tk} plain {tp}")
        check(diff <= 1e-3 * scale,
              "fp32 MoE kernel-path logits disagree with the plain path")
        return
    print(f"{what}, free-running (printed, not held: the flips): max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.3f} = "
          f"{diff / scale:.3e}; greedy token kernel {tk} plain {tp}")
    bf16_logit_check(torch, lk, lpin, f"{what}, the kernel path's expert "
                                      f"choices replayed")


# ------------------------------------------------------- phases 15-17

# phase 16's prompt: encoder frames and decoder tokens, bf16; its fp32
# parity halves both
ENCDEC_FRAMES, ENCDEC_TOKENS, ENCDEC_STEPS = 1024, 512, 16
# phase 17 runs qwen2-vl-72b at full width cut to this many of its 80
# layers: the 8 layers and the two 152064 x 8192 tables are 9.5 B
# parameters (19 GB in bf16); all 80 layers would need ~144 GB
VLM_LAYERS = 8
VLM_GRID = (1, 32, 64)      # (t, h, w) patches: 2048 positions
VLM_STEPS = 8


def run_prefill_path(torch, dev, cfg, model, params, batch, max_len: int,
                     steps: int, what: str) -> dict[str, int]:
    """One model through ``get_model(cfg)``'s prefill and decode steps: a
    timed prefill (after a warm-up) whose K6/K7 launches must equal
    ``launches_per_prefill(cfg)`` (counters reset just before), ``steps``
    greedy decode steps, the peak memory, a profiled prefill and decode
    step, and the bf16 kernel path against the plain path (the logit bar
    and greedy-token rule).  Returns the prefill's launch counts."""
    from repro_torch.kernels import ops

    with torch.inference_mode():
        model.prefill(params, batch, max_len)      # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        launches = {n: ops.launch_counts()[n] for n in LM_KERNELS}
        t0 = time.perf_counter()
        toks = _greedy(torch, model, params, logits, cache, steps)
        torch.cuda.synchronize()
        tpot = (time.perf_counter() - t0) * 1e3 / steps
    per = launches_per_prefill(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: {n_params / 1e9:.3f} B parameters; prefill {ttft:.3f} "
          f"ms, then {steps} greedy decode steps at {tpot:.3f} ms each (host "
          f"clock); tokens {toks[:8]}; launches {launches} (expected {per})")
    print(f"peak device memory {peak / 1e9:.3f} GB (< 80 GB)")
    check(launches == per, f"{what}: launches {launches}, expected {per}")
    check(peak < 80e9, f"peak device memory {peak / 1e9:.3f} GB >= 80 GB")
    run_prefill_profile(torch, dev, model, params, None, batch=batch,
                        max_len=max_len, what=f"{what} prefill")
    with torch.inference_mode():
        _, cache = model.prefill(params, batch, max_len)
    run_decode_profile(torch, dev, model, params, cache)
    del cache
    with torch.inference_mode():
        lk, _ = model.prefill(params, batch, max_len)
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
    bf16_logit_check(torch, lk, lp, f"{what} bf16 prefill")
    return launches


def ssm_path_phase(torch, dev) -> dict[str, int]:
    """Phase 15: mamba2-2.7b served at full width and depth, a profiled
    2048-token prefill and decode step, and its kernel path against its
    plain path (fp32 at 512 tokens, bf16 at 2048); returns the serving
    run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    launches = run_serve_phase(torch, dev, SSM_ARCH, 8)
    free_device_memory(torch)
    cfg = get_config(SSM_ARCH)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{SSM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, N {cfg.ssm_state}, "
          f"{n_params / 1e9:.3f} B parameters")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device=dev)
    run_prefill_profile(torch, dev, model, params, tokens)
    run_decode_profile(torch, dev, model, params)
    run_fp32_parity(torch, dev, tokens, SSM_ARCH)
    run_ssm_bf16_parity(torch, cfg, model, params, tokens)
    del params
    free_device_memory(torch)
    return launches


# how far the free-running bf16 kernel path may drift from the plain path,
# as a multiple of the plain path's own drift when its intra-chunk sum runs
# in another fp32 order (the noise floor of the model's bf16 roundings)
SSM_DRIFT_FACTOR = 2.0


def reordered_ssd_chunk_ref(x, dt_a, b, c):
    """The plain version of K7 (``ref.ssd_chunk_ref``) with its y sum over
    the chunk's source rows taken in two halves and then added: the same
    function, equally exact in fp32, rounded elsewhere."""
    import torch

    q = x.shape[1]
    xf, bf = x.float(), b.float()
    cs = torch.cumsum(dt_a.float(), dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.where(mask[None, :, :, None], torch.exp(seg),
                       torch.zeros((), device=x.device))
    w = torch.einsum("bthn,bshn->btsh", c.float(), bf) * lmat
    half = q // 2
    y = (torch.einsum("btsh,bshp->bthp", w[:, :, half:], xf[:, half:])
         + torch.einsum("btsh,bshp->bthp", w[:, :, :half], xf[:, :half]))
    state = torch.einsum("bshn,bsh,bshp->bhpn", bf,
                         torch.exp(cs[:, -1:, :] - cs), xf)
    return y.to(x.dtype), state, torch.exp(cs)


def run_ssm_bf16_parity(torch, cfg, model, params, tokens) -> None:
    """The Mamba2 LM's bf16 kernel path against its plain path at 2048
    tokens.  Free-running, a one-ulp flip of a bf16 rounding in one layer
    moves every later layer's input, and 64 layers of random weights
    amplify it: the plain path with its own intra-chunk sum reordered
    (``reordered_ssd_chunk_ref``) drifts about as far as the kernel path.
    So the free-running logits are held to the greedy-token rule and to
    BF16_LOGIT_RTOL of the largest logit or, where the noise floor is above
    half that, to SSM_DRIFT_FACTOR times the floor; and BF16_LOGIT_RTOL
    holds layer by layer: each layer of the kernel path, fed the plain
    path's hidden state, within it of the plain layer's largest output."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models.tree import layer

    what = f"{SSM_ARCH} bf16 {tokens.shape[1]}-token prefill"
    batch, max_len = {"tokens": tokens}, tokens.shape[1] + 16
    plain_ssd = ref.ssd_chunk_ref
    with torch.inference_mode():
        lk, _ = model.prefill(params, batch, max_len)
        lp, _ = model.prefill(params, batch, max_len, mode="ref")
        try:
            ref.ssd_chunk_ref = reordered_ssd_chunk_ref
            lo, _ = model.prefill(params, batch, max_len, mode="ref")
        finally:
            ref.ssd_chunk_ref = plain_ssd
        h = L.embed(params["embedding"], tokens)
        per_layer = []
        for i in range(cfg.n_layers):
            lp_i = layer(params["layers"], i)
            hk = M.block_apply(lp_i, h, cfg)
            h = M.block_apply(lp_i, h, cfg, mode="ref")
            per_layer.append(((hk.float() - h.float()).abs().max()
                              / h.float().abs().max()).item())
    scale = lp.abs().max().item()
    drift = (lk - lp).abs().max().item()
    floor = (lo - lp).abs().max().item()
    top2 = torch.topk(lp[0, -1], 2).values
    gap = (top2[0] - top2[1]).item()
    tk, tp = int(torch.argmax(lk[0, -1])), int(torch.argmax(lp[0, -1]))
    bar = max(BF16_LOGIT_RTOL * scale, SSM_DRIFT_FACTOR * floor)
    print(f"{what}, free-running: max |dlogit| {drift:.4e} of max |logit| "
          f"{scale:.3f} = {drift / scale:.3e}; the plain path with its "
          f"intra-chunk sum reordered: {floor / scale:.3e} (noise floor), "
          f"the kernel path at {drift / max(floor, 1e-30):.2f} times it; "
          f"held to {bar / scale:.3e} (the larger of {BF16_LOGIT_RTOL:g} and "
          f"{SSM_DRIFT_FACTOR:g} x the floor); plain top-2 gap {gap:.4e}; "
          f"greedy token kernel {tk} plain {tp}")
    check(drift <= bar, "bf16 kernel-path logits drift past the larger of "
                        "the logit bar and twice the noise floor")
    if gap > 2 * drift:
        check(tk == tp, "bf16 greedy token differs where the top-2 gap "
                        "exceeds twice the logit difference")
    worst = max(per_layer)
    print(f"{what}, layer by layer (each kernel-path layer fed the plain "
          f"path's hidden state), max |dh| / max |h| by layer: "
          + " ".join(f"{r:.1e}" for r in per_layer[::8])
          + f"; worst {worst:.3e} (<= {BF16_LOGIT_RTOL:g})")
    check(worst <= BF16_LOGIT_RTOL,
          "a bf16 kernel-path layer disagrees with the plain path")


def _paths(tree, prefix=""):
    """(path, leaf) of a dict tree, in its dicts' order."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _paths(v, f"{prefix}/{key}")
    else:
        yield prefix, tree


def _leaves(tree):
    return (leaf for _, leaf in _paths(tree))


def _greedy(torch, model, params, logits, cache, steps: int) -> list[int]:
    """``steps`` greedy decode steps from a prefill's logits and cache; the
    tokens chosen (of row 0)."""
    out = []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(int(tok[0, 0]))
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
    return out


def encdec_batch(torch, dev, cfg, gen, frames: int, tokens: int) -> dict:
    """Random frame embeddings (the front end's stub, at the scale of the
    token embeddings) and decoder tokens."""
    emb = torch.randn((1, frames, cfg.d_model), generator=gen, device=dev)
    return {"enc_embeds": (emb * 0.02).to(getattr(torch, cfg.dtype)),
            "dec_tokens": torch.randint(0, cfg.vocab_size, (1, tokens),
                                        generator=gen, device=dev)}


def encdec_path_phase(torch, dev) -> dict[str, int]:
    """Phase 16: seamless-m4t-large-v2 at full width and depth through
    ``get_model(cfg).prefill``/``decode_step`` (the serving runner refuses
    the encoder-decoder, as the reference's does), then in fp32 at full
    width and depth on half the frames and tokens; returns the launch
    counts of the measured prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(ENCDEC_ARCH)
    model = get_model(cfg)
    print(f"{ENCDEC_ARCH}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}; {ENCDEC_FRAMES} frames, "
          f"{ENCDEC_TOKENS} tokens")
    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = model.init(gen, dev)
        batch = encdec_batch(torch, dev, cfg, gen, ENCDEC_FRAMES,
                             ENCDEC_TOKENS)
    launches = run_prefill_path(torch, dev, cfg, model, params, batch,
                                ENCDEC_TOKENS + 32, ENCDEC_STEPS,
                                f"{ENCDEC_ARCH} {ENCDEC_FRAMES}-frame, "
                                f"{ENCDEC_TOKENS}-token")
    del params
    free_device_memory(torch)
    # fp32 at full width and depth: 512 frames / 256 tokens, 8 greedy steps
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    m32 = get_model(cfg32)
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(1)
        p32 = m32.init(gen, dev)
        b32 = encdec_batch(torch, dev, cfg32, gen, ENCDEC_FRAMES // 2,
                           ENCDEC_TOKENS // 2)
        lk, ck = m32.prefill(p32, b32, ENCDEC_TOKENS // 2 + 16)
        lp, cp = m32.prefill(p32, b32, ENCDEC_TOKENS // 2 + 16, mode="ref")
        for step in range(9):
            diff = (lk - lp).abs().max().item()
            scale = lp.abs().max().item()
            print(f"{ENCDEC_ARCH} fp32 {ENCDEC_FRAMES // 2} frames, "
                  f"{ENCDEC_TOKENS // 2} tokens, "
                  f"{'prefill' if step == 0 else f'decode {step}'}: max "
                  f"|dlogit| {diff:.3e} of max |logit| {scale:.3f} = "
                  f"{diff / scale:.3e} (<= 1e-3)")
            check(diff <= 1e-3 * scale, "fp32 encoder-decoder kernel-path "
                                        "logits disagree with the plain path")
            if step == 8:
                break
            tok = torch.argmax(lp[:, -1], dim=-1)[:, None]
            lk, ck = m32.decode_step(p32, ck, {"tokens": tok})
            lp, cp = m32.decode_step(p32, cp, {"tokens": tok})
        for key in ("k", "v", "mem_k", "mem_v"):
            a, r = errors(ck[key], cp[key])
            print(f"fp32 cache {key}: max_abs {a:.3e} max_rel {r:.3e}")
    del p32, ck, cp
    free_device_memory(torch)
    return launches


def vlm_path_phase(torch, dev) -> dict[str, int]:
    """Phase 17: qwen2-vl-72b at full width cut to VLM_LAYERS layers, a
    prefill of an image grid's embeddings at their M-RoPE positions and
    greedy decode steps, its bf16 kernel path against its plain path;
    returns the launch counts of the measured prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import vlm
    from repro_torch.models.api import get_model

    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=VLM_LAYERS)
    print(f"{VLM_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads on {cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, M-RoPE {cfg.mrope_sections}), cut to "
          f"{VLM_LAYERS} of {full.n_layers} layers: all of them would need "
          f"~144 GB in bf16")
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t, h, w = VLM_GRID
    with torch.inference_mode():
        params = model.init(gen, dev)
        emb = torch.randn((1, t * h * w, cfg.d_model), generator=gen,
                          device=dev)
        batch = {"embeds": (emb * 0.02).to(torch.bfloat16),
                 "positions": vlm.make_image_positions(1, t, h, w, dev)}
    launches = run_prefill_path(torch, dev, cfg, model, params, batch,
                                t * h * w + 16, VLM_STEPS,
                                f"{VLM_ARCH} ({VLM_LAYERS} layers) "
                                f"{t}x{h}x{w}-patch grid")
    del params
    free_device_memory(torch)
    return launches


def family_path_phases(torch, dev) -> dict[str, dict[str, int]]:
    """Phases 15-17; returns each path's K6/K7 launch counts by arch (the
    serving run's for mamba2-2.7b, one prefill's for the others)."""
    phase(15, f"serve {SSM_ARCH}, full width, bf16, 8 requests on 4 slots; "
              f"kernel path against plain path")
    launches = {SSM_ARCH: ssm_path_phase(torch, dev)}
    phase(16, f"{ENCDEC_ARCH}, full width, bf16: prefill of "
              f"{ENCDEC_FRAMES} frames and {ENCDEC_TOKENS} tokens, "
              f"{ENCDEC_STEPS} decode steps; kernel path against plain path")
    launches[ENCDEC_ARCH] = encdec_path_phase(torch, dev)
    phase(17, f"{VLM_ARCH}, full width cut to {VLM_LAYERS} layers, bf16: "
              f"image-grid prefill, {VLM_STEPS} decode steps; kernel path "
              f"against plain path")
    launches[VLM_ARCH] = vlm_path_phase(torch, dev)
    return launches


# -------------------------------------------------------------- phase 18

TRAIN_ARCH = "granite-3-2b"
TRAIN_HYBRID_ARCH = "zamba2-1.2b"
TRAIN_SEQ = 2048
TRAIN_STEPS = 5           # AdamW steps of granite-3-2b, microbatches 2
TRAIN_INT8_STEPS = 3      # then with int8 error feedback
TRAIN_HYBRID_STEPS = 3    # Zamba2-1.2B, batch 1
TRAIN_SSM_STEPS = 3       # mamba2-2.7b, batch 1
# the kernel path against the plain path (the loss's K4/K5, attention's K6
# and the SSD's K7 and their backwards against their plain versions) on
# granite's and Zamba2-1.2B's first step: the loss (fp32 sums of 49408
# classes in another order, bf16 attention outputs a rounding apart) and
# the global gradient norm (the
# fp32 dlogits, a few ulps apart, become bf16 gradients of the hidden
# states, whose roundings then differ through 40 layers: 2.8e-4 measured
# with plain attention on both paths), and each gradient leaf relative to
# its norm (the bf16 train bar of PERF.md §2)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-2
TRAIN_LEAF_RTOL = 5e-2
# Zamba2-1.2B's step-1 loss, kernel path against plain path: 1e-4, the
# smoke step's card bar for the same comparison (tests/test_torch_lm_train.py
# BF16_STEP_LOSS_RTOL).  1e-5 lies under the plain path's own noise there:
# the plain path with its SSD's y sum taken in two halves
# (``reordered_ssd_chunk_ref``) moves the loss by 2.611e-5, K6 alone by
# 2.037e-5, K7 alone by 2.161e-5, both 6.350e-5, while every K7 launch of
# the step and its backward lie within phase 7's bars of their plain
# versions (ROADMAP F4); phase 18b prints that witness beside the gap
TRAIN_HYBRID_LOSS_RTOL = 1e-4
# the plain versions of attention and of the SSD, which no kernel-path
# train step may reach
TRAIN_PLAIN_FNS = ("flash_attention_ref", "flash_attention_lse_ref",
                   "flash_attention_bwd_ref", "ssd_chunk_ref",
                   "ssd_chunk_bwd_ref")


def train_launches(cfg, microbatches: int, kernel_path: bool
                   ) -> dict[str, int]:
    """The launches of K4-K7 and the backwards of K6 and K7 that one train
    step of ``cfg`` makes: the loss's K4 and K5 once a microbatch; each
    attention layer's K6 and each Mamba2 layer's K7 once a microbatch,
    twice under remat (the recompute of its layer's forward), and the
    backward of each once.  A dense, MoE or VLM layer holds one attention;
    an encoder-decoder's encoder layer one (full), its decoder layer two
    (causal self-attention and cross-attention over the memory, both
    inside the remat'd layer).  Zamba2's shared block is not under remat,
    its Mamba2 layers are.  The plain path (``mode="ref"``) launches
    nothing."""
    from repro_torch.models import zamba2 as Z

    if not kernel_path:
        return dict.fromkeys(("softmax_xent_fwd", "softmax_xent_dlogits",
                              "flash_attention", "flash_attention_bwd",
                              "ssd_chunk", "ssd_chunk_bwd"), 0)
    fwd = 2 if cfg.remat else 1
    if cfg.family == "hybrid":
        attn, attn_fwd, mamba = Z.n_shared_invocations(cfg), 1, cfg.n_layers
    elif cfg.family == "ssm":
        attn, attn_fwd, mamba = 0, fwd, cfg.n_layers
    elif cfg.family == "encdec":
        attn, attn_fwd, mamba = cfg.n_encoder_layers + 2 * cfg.n_layers, fwd, 0
    elif cfg.family in ("dense", "moe", "vlm"):
        attn, attn_fwd, mamba = cfg.n_layers, fwd, 0
    else:
        raise ValueError(f"train_launches: unknown family {cfg.family!r}")
    return {"softmax_xent_fwd": microbatches,
            "softmax_xent_dlogits": microbatches,
            "flash_attention": attn_fwd * attn * microbatches,
            "flash_attention_bwd": attn * microbatches,
            "ssd_chunk": fwd * mamba * microbatches,
            "ssd_chunk_bwd": mamba * microbatches}


def gemm_f32_backward_ms(torch, dev, m: int, k: int, n: int
                         ) -> tuple[float, float]:
    """Device ms of the backward of a bf16 (m, k) @ (k, n) product written
    in fp32, for an fp32 cotangent: as the port runs it
    (``layers.gemm_f32_grads``: the cotangent split into bf16 hi + lo, two
    GEMMs a product) and with the cotangent rounded once to bf16 (one GEMM
    a product)."""
    from repro_torch.models.layers import gemm_f32_grads

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    w = torch.randn(k, n, generator=gen, device=dev).bfloat16()
    g = torch.randn(m, n, generator=gen, device=dev)

    def once():
        gb = g.bfloat16()
        return torch.mm(gb, w.t()), torch.mm(x.t(), gb)

    return (device_ms(lambda: gemm_f32_grads(x, w, g, torch.mm), iters=5,
                      replays=5),
            device_ms(once, iters=5, replays=5))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def train_batch(torch, dev, cfg, batch: int, gen, seq: int | None = None):
    """A seeded training batch of ``seq`` (default TRAIN_SEQ) positions with
    the keys, shapes and dtypes of ``model.input_specs`` for a train shape:
    ``batch`` rows of seq + 1 token ids as tokens and their next-token
    labels; for the encoder-decoder seq // 2 frame embeddings (the front
    end's stub, at the token embeddings' scale, in ``cfg.dtype``) and the
    rest as decoder tokens; for the VLM seq patch embeddings at M-RoPE
    positions (3, B, seq): an image grid of 1 x 32 x (seq // 64) patches
    (``vlm.make_image_positions``) followed by its text, the text's
    positions past the grid's largest (``vlm.make_text_positions``)."""
    from repro_torch.models import vlm

    seq = seq or TRAIN_SEQ
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        frames = seq // 2
        seq -= frames
    tok = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                        generator=gen, device=dev, dtype=torch.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        emb = torch.randn((batch, frames, cfg.d_model), generator=gen,
                          device=dev)
        return {"enc_embeds": (emb * 0.02).to(dt),
                "dec_tokens": out["tokens"], "labels": out["labels"]}
    if cfg.family == "vlm":
        emb = torch.randn((batch, seq, cfg.d_model), generator=gen,
                          device=dev)
        w = max(seq // 64, 1)
        grid = min(32 * w, seq)
        image = vlm.make_image_positions(batch, 1, grid // w, w, dev)
        text = vlm.make_text_positions(batch, seq - grid, dev) + (
            int(image.max()) + 1 if grid else 0)
        return {"embeds": (emb * 0.02).to(dt),
                "positions": torch.cat([image, text], dim=-1).contiguous(),
                "labels": out["labels"]}
    return out


def run_train(torch, model, settings, state, batch, steps: int, what: str,
              mode=None, around: Callable | None = None):
    """``steps`` steps of ``launch.steps.build_train_step``: per step the
    loss, the gradient norm, host ms (synchronised), the peak memory since
    the caller's last reset (the allocator's, and the bytes the program
    requested, without the allocator's block rounding) and the launches
    (counters reset just before
    the step, read just after), which must be
    ``train_launches``'s for the model and ``mode``; on the kernel path no
    plain version of attention or of the SSD may be reached
    (``PlainSpy``).  ``around(i)``, where given, is a context manager that
    step i runs in (the MoE's ``ExpertChoices``).  Returns (the state after
    the steps, the rows)."""
    import math

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step

    step = build_train_step(model, settings, mode=mode)
    expected = train_launches(model.cfg, settings.microbatches, mode != "ref")
    out = []
    for i in range(steps):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with (around(i) if around else contextlib.nullcontext()), \
                PlainSpy(TRAIN_PLAIN_FNS) as spy:
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        row = {"loss": metrics["loss"].item(),
               "grad_norm": metrics["grad_norm"].item(), "ms": ms,
               "launches": launches,
               "peak": torch.cuda.max_memory_allocated(),
               "requested_peak":
                   torch.cuda.memory_stats()["requested_bytes.all.peak"]}
        out.append(row)
        print(f"{what} step {i + 1}: loss {row['loss']:.6f} grad_norm "
              f"{row['grad_norm']:.6f} host {ms:.1f} ms; K4 "
              f"{launches['softmax_xent_fwd']} K5 "
              f"{launches['softmax_xent_dlogits']} K6 "
              f"{launches['flash_attention']} K6 bwd "
              f"{launches['flash_attention_bwd']} K7 {launches['ssd_chunk']} "
              f"K7 bwd {launches['ssd_chunk_bwd']}; plain attention and SSD "
              f"reached {sum(spy.calls.values())} times",
              flush=True)
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
              f"{what}: step {i + 1} is not finite")
        got = {name: launches[name] for name in expected}
        check(got == expected, f"{what}: launches {got} in a step, expected "
                               f"{expected}")
        check(mode == "ref" or not any(spy.calls.values()),
              f"{what}: a kernel-path step reached a plain version "
              f"{spy.calls}")
    if steps > 1:
        check(out[-1]["loss"] < out[0]["loss"],
              f"{what}: the loss did not fall ({out[0]['loss']:.6f} -> "
              f"{out[-1]['loss']:.6f})")
    return state, out


def profile_train_step(torch, step) -> tuple[float, list]:
    """Device busy ms of one train step from torch.profiler, and its
    device operations (name, count, us), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(device_rows(prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    return busy or float("nan"), rows


def fwd_bwd_ms(torch, fn, inputs, reps: int = 5) -> tuple[float, float]:
    """(forward ms, forward + backward ms) of ``fn(*inputs)`` under
    autograd: the device busy time a call, summed over the device
    operations torch.profiler records in ``reps`` calls after a warm-up
    (host gaps left out), nan where it records none.  The backward takes
    a contiguous cotangent made beforehand (no reduction, no copy of a
    stride-0 one) and accumulates no .grad."""
    from torch.profiler import ProfilerActivity, profile

    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    grads = [t for t in leaves if t.requires_grad]

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    cot = torch.ones_like(first(fn(*leaves)))

    def fwd():
        return fn(*leaves)

    def both():
        torch.autograd.grad(first(fn(*leaves)), grads, cot, allow_unused=True)

    times = []
    for f in (fwd, both):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                f()
            torch.cuda.synchronize()
        us = sum(us for _, _, us in device_rows(prof))
        times.append(us / 1e3 / reps if us else float("nan"))
    return times[0], times[1]


def print_profile(what: str, busy: float, host_ms: float, rows) -> None:
    if not rows:
        print(f"{what}: device time not measured (the profiler recorded no "
              f"device events)")
        return
    print(f"{what}: device busy {busy:.3f} ms of {host_ms:.3f} ms host "
          f"({100 * busy / host_ms:.1f}%; idle "
          f"{100 - 100 * busy / host_ms:.1f}%), "
          f"{sum(c for _, c, _ in rows)} device operations")
    for key, count, us in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d} calls  {key[:100]}")


# granite-3-2b's train step with plain attention on the card (PERF.md §5):
# host ms/step and device busy, printed beside this run's
PLAIN_ATTENTION_STEP = (1451.8, 1416.6)


def attention_train_ms(torch, dev, cfg, layers: int, recompute: bool
                       ) -> tuple[str, float, float]:
    """Attention in a train step, composed from its time alone at the
    step's shape ((1, n_heads, TRAIN_SEQ, head_dim) on n_kv_heads) times
    ``layers`` calls a step, its forward twice where ``recompute`` — an
    estimate, not a share of the profiled step: the kernels by graph
    replay (``device_ms``: K6 with its lse, K6's backward), the plain
    version under autograd by its device rows (``fwd_bwd_ms``).  Returns
    (a line, the kernels' ms, the plain version's ms)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = torch.randn(1, h, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(1, kv, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(1, kv, TRAIN_SEQ, hd, generator=gen, device=dev).to(dt)
    o, lse = flash_attention(q, k, v, True, lse=True)
    do = torch.randn(o.shape, generator=gen, device=dev).to(dt)
    kf = device_ms(lambda: flash_attention(q, k, v, True, lse=True))
    kb = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, True))
    calls = 2 if recompute else 1
    kern = layers * (calls * kf + kb)
    pf, pfb = fwd_bwd_ms(torch, lambda q, k, v: ops.flash_attention(
        q, k, v, True, mode="ref"), (q, k, v))
    plain = layers * (calls * pf + pfb - pf)
    line = (f"attention at (1, {h}, {TRAIN_SEQ}, {hd}) on {kv} KV heads, "
            f"alone: K6 with its lse {kf:.4f} ms, K6's backward {kb:.4f} ms "
            f"(graph replay); the plain version forward {pf:.3f}, forward + "
            f"backward {pfb:.3f} ms (device rows); x {layers} calls a step"
            f"{' with the recompute' if recompute else ''} = {kern:.1f} ms "
            f"on the kernels, {plain:.1f} ms plain (composed: an estimate)")
    return line, kern, plain


# the profiled step's rows of K6 and its backward, and of K7 and its
# backward: (label, a substring of the kernel's name)
K6_ROWS = (("K6", "flash_fwd"), ("K6 bwd prep", "flash_bwd_prep"),
           ("K6 bwd dK/dV/dQ", "flash_bwd_wgmma"),
           ("K6 bwd dQ rounded", "flash_bwd_dq_round"),
           ("K6 bwd fp32 dK/dV/dQ", "flash_bwd_tf32"),
           ("K6 bwd fp32 dQ summed", "flash_bwd_dq_sum"))
# K7 and its backward by profiler row: the bf16 backward's kernel (a block
# the heads of a B/C group) and the sum of each group's parts (one fp32
# part a block; no launch where a block is a whole group)
K7_ROWS = (("K7", "ssd_chunk_wgmma"), ("K7 fp32", "ssd_chunk_tf32"),
           ("K7 bwd", "ssd_bwd_wgmma"), ("K7 bwd fp32", "ssd_bwd_tf32"),
           ("K7 bwd group sum", "group_sum"))


def step_rows_ms(prof_rows, busy: float, what: str, tags) -> float:
    """The device ms of ``what`` in a profiled step: its rows (``tags``,
    K6_ROWS or K7_ROWS), printed by kernel with their share of the step's
    device busy time."""
    ms = {n: sum(us for key, _, us in prof_rows if tag in key) / 1e3
          for n, tag in tags}
    total = sum(ms.values())
    print(f"{what} in the profiled step: " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in ms.items())
        + f" = {total:.3f} ms, {100 * total / busy:.1f}% of device busy")
    return total


def microbatched(batch, microbatches: int) -> dict:
    """``batch`` split as ``launch.steps`` splits it, on a leading axis of
    ``microbatches`` (one batch of one: the VLM's (3, B, S) positions
    keep their layout)."""
    return {k: v.reshape((microbatches, v.shape[0] // microbatches)
                         + tuple(v.shape[1:])) for k, v in batch.items()}


def step_grads(model, params, batch, microbatches: int, mode=None,
               around: Callable = contextlib.nullcontext):
    """(loss, gradients) of one step's loss from ``params``, as
    ``launch.steps`` takes them (``accumulate_grads`` over microbatches, or
    one ``value_and_grad``), in ``mode``, inside ``around()``."""
    from repro_torch.parallel import gradsync

    def loss_fn(p, b):
        return model.loss_fn(p, b, mode=mode)

    with around():
        if microbatches > 1:
            return gradsync.accumulate_grads(
                loss_fn, params, microbatched(batch, microbatches))
        return gradsync.value_and_grad(loss_fn)(params, batch)


def step_loss(torch, model, params, batch, microbatches: int, mode=None,
              around: Callable = contextlib.nullcontext) -> float:
    """``step_grads``'s loss alone, without the gradients: each
    microbatch's loss summed in fp32 in order, then divided by their
    count, as ``accumulate_grads`` takes it."""
    micro = microbatched(batch, microbatches)
    with torch.no_grad(), around():
        total = None
        for i in range(microbatches):
            loss = model.loss_fn(params, {k: v[i] for k, v in micro.items()},
                                 mode=mode)
            total = loss if total is None else total + loss
    return (total / microbatches).item()


def leaf_errors(a, b) -> list[tuple[str, float]]:
    """(path, ||a − b|| / ||b||) of every leaf of two gradient trees,
    largest first."""
    out = [(path, ((x.float() - y.float()).norm()
                   / y.float().norm().clamp_min(1e-30)).item())
           for (path, x), (_, y) in zip(_paths(a), _paths(b))]
    return sorted(out, key=lambda r: -r[1])


def grad_leaf_errors(torch, model, params, batch, microbatches: int,
                     around: Callable = contextlib.nullcontext
                     ) -> list[tuple[str, float]]:
    """(path, ||g_kernel − g_plain|| / ||g_plain||) of every gradient leaf
    of one step's loss from ``params``, the kernel path's against the plain
    path's, largest first; each path's gradients taken inside
    ``around()``."""
    _, kernel = step_grads(model, params, batch, microbatches, None, around)
    _, plain = step_grads(model, params, batch, microbatches, "ref", around)
    out = leaf_errors(kernel, plain)
    del kernel, plain
    return out


def granite_train_phase(torch, dev, smi: str) -> dict:
    """Phase 18a: granite-3-2b at full width and depth trained by
    ``build_train_step``; returns K4/K5's and K6's launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models.api import get_model

    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg)
    settings = TrainSettings(microbatches=2)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    batch = train_batch(torch, dev, cfg, 2,
                        torch.Generator(device=dev).manual_seed(1))
    print(f"{TRAIN_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads on {cfg.n_kv_heads} KV heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}, tied; {n_params / 1e9:.3f} B "
          f"parameters in {cfg.param_dtype}, fp32 moments, remat "
          f"{cfg.remat} ({cfg.remat_policy}); batch 2 x {TRAIN_SEQ}, "
          f"microbatches 2 (K4 at ({TRAIN_SEQ}, {cfg.padded_vocab}) each)")
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_STEPS, TRAIN_ARCH)
    peak = torch.cuda.max_memory_allocated()
    gb = 1e9
    p_bytes = _tree_bytes(state["params"])
    m_bytes = _tree_bytes(state["opt"])
    logits = 2 * TRAIN_SEQ * cfg.padded_vocab * 4
    print(f"memory reckoned: parameters {p_bytes / gb:.2f} GB, gradients "
          f"{p_bytes / gb:.2f}, moments {m_bytes / gb:.2f}, fp32 logits and "
          f"dlogits of a microbatch {logits / gb:.2f}, plus one layer's "
          f"recompute = {(2 * p_bytes + m_bytes + logits) / gb:.2f} GB and "
          f"up; measured peak {peak / gb:.3f} GB "
          f"(torch.cuda.max_memory_allocated; < 80 GB)")
    check(peak < 80e9, f"{TRAIN_ARCH} train peak {peak / gb:.3f} GB >= 80 GB")
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{TRAIN_ARCH} train step (profiled, one step; host ms the "
                  f"median of steps 2-{TRAIN_STEPS})", busy, host_ms,
                  prof_rows)
    # attention of one layer at the step's shape, forward and forward +
    # backward, alone: x n_layers x 2 microbatches, its forward twice (the
    # remat recomputes it)
    line, attn, plain_attn = attention_train_ms(
        torch, dev, cfg, cfg.n_layers * settings.microbatches, True)
    print(line)
    k6_ms = step_rows_ms(prof_rows, busy, "K6 and its backward", K6_ROWS)
    xent = {n: sum(us for key, _, us in prof_rows if tag in key) / 1e3
            for n, tag in (("K4", "xent_fwd"), ("K4 mean", "xent_mean"),
                           ("K5", "xent_dlogits"))}
    print(f"K4/K5 in the profiled step: " + ", ".join(
        f"{n} {ms:.4f} ms" for n, ms in xent.items())
        + f" = {100 * sum(xent.values()) / busy:.2f}% of device busy")

    # kernel path against plain path, first step from the same weights
    del state, step
    plain = plain_path_step1(torch, model, settings, batch, rows, TRAIN_ARCH)
    print(f"peak from the state's making through step 1, requested: kernel "
          f"path {rows[0]['requested_peak']} B, plain path "
          f"{plain['requested_peak']} B (the kernel path's no higher); "
          f"allocated (blocks, the allocator's rounding and the cuBLAS "
          f"workspaces its first steps add): {rows[0]['peak']} B, "
          f"{plain['peak']} B; through {TRAIN_STEPS} steps {peak} B")
    check(rows[0]["requested_peak"] <= plain["requested_peak"],
          "granite kernel path peaks above the plain path")

    # int8 error feedback
    settings8 = TrainSettings(microbatches=2, grad_compression="int8")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings8,
                             torch.Generator(device=dev).manual_seed(0), dev)
    state, rows8 = run_train(torch, model, settings8, state, batch,
                             TRAIN_INT8_STEPS, f"{TRAIN_ARCH} int8")
    peak8 = torch.cuda.max_memory_allocated()
    r_bytes = _tree_bytes(state["residual"])
    print(f"int8: residual {r_bytes / gb:.2f} GB (fp32), dequantized fp32 "
          f"grads {2 * p_bytes / gb:.2f} GB; measured peak {peak8 / gb:.3f} "
          f"GB (< 80 GB)")
    check(peak8 < 80e9, f"{TRAIN_ARCH} int8 peak {peak8 / gb:.3f} GB")
    del state
    free_device_memory(torch)
    # what the split cotangent costs: the gate and up products of each
    # layer and the unembedding, per microbatch
    t, d = TRAIN_SEQ, cfg.d_model
    mlp = gemm_f32_backward_ms(torch, dev, t, d, cfg.d_ff)
    emb = gemm_f32_backward_ms(torch, dev, t, d, cfg.padded_vocab)
    split_cost = 2 * (2 * cfg.n_layers * (mlp[0] - mlp[1]) + emb[0] - emb[1])
    print(f"backward of a bf16 product written in fp32, the cotangent split "
          f"(hi + lo) vs rounded once: gate/up ({t}, {d}) @ ({d}, "
          f"{cfg.d_ff}) {mlp[0]:.4f} vs {mlp[1]:.4f} ms, unembedding ({t}, "
          f"{d}) @ ({d}, {cfg.padded_vocab}) {emb[0]:.4f} vs {emb[1]:.4f} "
          f"ms; x (2 x {cfg.n_layers} layers + 1) x 2 microbatches = "
          f"{split_cost:.1f} ms a step ({100 * split_cost / busy:.1f}% of "
          f"device busy)")
    free_device_memory(torch)
    ms8 = sorted(r["ms"] for r in rows8[1:])
    print(f"{TRAIN_ARCH} train on {smi}: {host_ms:.1f} ms/step (batch 2 x "
          f"{TRAIN_SEQ}, 2 microbatches), device busy {busy:.1f} ms, peak "
          f"{peak / gb:.3f} GB; int8 {ms8[len(ms8) // 2]:.1f} ms/step, peak "
          f"{peak8 / gb:.3f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_STEPS} steps; K6 and its "
          f"backward {k6_ms:.1f} ms = {100 * k6_ms / busy:.1f}% of the "
          f"profiled step's device busy (composed estimate {attn:.1f} ms, "
          f"its plain version's {plain_attn:.1f} ms); with plain attention "
          f"(PERF.md §5) {PLAIN_ATTENTION_STEP[0]} ms/step, busy "
          f"{PLAIN_ATTENTION_STEP[1]} ms")
    launched = {name: sum(r["launches"][name] for r in rows)
                for name in ("softmax_xent_fwd", "flash_attention",
                             "flash_attention_bwd")}
    return {"launches": launched["softmax_xent_fwd"], "k6": launched,
            "steps": TRAIN_STEPS, "ms_per_step": host_ms, "busy_ms": busy,
            "attention_share": k6_ms / busy, "n_params": n_params}


def ssd_train_ms(torch, dev, cfg) -> tuple[str, float, float]:
    """The SSD (``mamba2.ssd_chunked``) of one Mamba2 layer at the step's
    shape (TRAIN_SEQ tokens, one B/C group), alone, under autograd: its
    forward and forward + backward device time on the kernel path (K7 and
    its backward with the inter-chunk recurrence and readout) and on the
    plain path, by the profiler's device rows (``fwd_bwd_ms``), times
    ``cfg.n_layers`` with the forward twice (the remat recompute).  Returns
    (a line, the kernel path's ms, the plain path's ms): an estimate, not a
    share of the profiled step."""
    from repro_torch.models import mamba2 as M

    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = torch.randn(1, TRAIN_SEQ, h, p, generator=gen, device=dev).to(dt)
    dt_a = -torch.rand(1, TRAIN_SEQ, h, generator=gen, device=dev) * 0.1
    b = torch.randn(1, TRAIN_SEQ, 1, n, generator=gen, device=dev).to(dt)
    c = torch.randn(1, TRAIN_SEQ, 1, n, generator=gen, device=dev).to(dt)
    out = {}
    for mode in (None, "ref"):
        f_ms, fb_ms = fwd_bwd_ms(
            torch, lambda x, a, b, c, m=mode: M.ssd_chunked(
                x, a, b, c, cfg.ssm_chunk, mode=m), (x, dt_a, b, c))
        out[mode] = (f_ms, fb_ms, cfg.n_layers * (2 * f_ms + fb_ms - f_ms))
    line = (f"SSD (ssd_chunked) of one layer at ({TRAIN_SEQ} tokens, {h} "
            f"heads of {p}, state {n}), device time alone: kernel path "
            f"forward {out[None][0]:.3f} ms, forward + backward "
            f"{out[None][1]:.3f} ms; plain path {out['ref'][0]:.3f}, "
            f"{out['ref'][1]:.3f} ms; x {cfg.n_layers} layers with the "
            f"recompute = {out[None][2]:.1f} ms on the kernels, "
            f"{out['ref'][2]:.1f} ms plain (composed: an estimate)")
    return line, out[None][2], out["ref"][2]


def plain_path_step1(torch, model, settings, batch, rows, what: str,
                     loss_rtol: float = TRAIN_LOSS_RTOL,
                     leaf_rtol: float = TRAIN_LEAF_RTOL,
                     around: Callable = contextlib.nullcontext,
                     witness: bool = False) -> dict:
    """Step 1 of the kernel path (``rows[0]``) held to the plain path's
    from the same weights (seed 0): the loss within ``loss_rtol``, the
    global gradient norm within TRAIN_GNORM_RTOL and each gradient leaf
    within ``leaf_rtol`` (``grad_leaf_errors``), every step and gradient
    taken inside ``around()`` (the MoE's replayed expert choices).  With
    ``witness``, the plain path's own noise on this batch is printed beside
    the bars, not held: the plain path with the reference's chunked
    attention (``chunked_plain_attention``) against itself, the loss and
    each leaf.  Returns the plain step's ``run_train`` row, its peaks
    counted from the state's making."""
    from repro_torch.launch.steps import init_train_state

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    dev = batch["labels"].device
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    state, (plain,) = run_train(torch, model, settings, state, batch, 1,
                                f"{what} plain path", mode="ref",
                                around=lambda _: around())
    del state
    free_device_memory(torch)
    params = init_train_state(model, settings,
                              torch.Generator(device=dev).manual_seed(0),
                              dev)["params"]
    free_device_memory(torch)
    if witness:
        _, kernel = step_grads(model, params, batch, settings.microbatches,
                               None, around)
        lp, plain_g = step_grads(model, params, batch, settings.microbatches,
                                 "ref", around)
        leaves = leaf_errors(kernel, plain_g)
        del kernel
        with chunked_plain_attention():
            lw, chunked = step_grads(model, params, batch,
                                     settings.microbatches, "ref", around)
        noise = leaf_errors(chunked, plain_g)
        del chunked, plain_g
        print(f"the plain path's own noise on this batch (printed, not held):"
              f" the plain path with the reference's chunked attention at "
              f"{WITNESS_CHUNK}-key chunks against itself moves the loss by "
              f"{abs(lw.item() - lp.item()) / abs(lp.item()):.3e} relative "
              f"and the leaves by worst {noise[0][0]} {noise[0][1]:.3e}, "
              f"then " + ", ".join(f"{p} {r:.2e}" for p, r in noise[1:6])
              + f"; the bars {loss_rtol:.3e} and {leaf_rtol:.3e} are twice "
              f"the largest such move over batches 1-5 "
              f"(tools/train_loss_noise.py, ROADMAP F5)")
    else:
        leaves = grad_leaf_errors(torch, model, params, batch,
                                  settings.microbatches, around)
    del params
    free_device_memory(torch)
    loss_rel = abs(rows[0]["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_rel = (abs(rows[0]["grad_norm"] - plain["grad_norm"])
              / abs(plain["grad_norm"]))
    print(f"{what} kernel path against plain path, step 1: loss "
          f"{rows[0]['loss']:.7f} vs {plain['loss']:.7f} (rel {loss_rel:.3e}"
          f" <= {loss_rtol:.3e}); grad_norm {rows[0]['grad_norm']:.6f} "
          f"vs {plain['grad_norm']:.6f} (rel {gn_rel:.3e} <= "
          f"{TRAIN_GNORM_RTOL:g})")
    check(loss_rel <= loss_rtol, f"{what} kernel/plain losses differ")
    check(gn_rel <= TRAIN_GNORM_RTOL, f"{what} kernel/plain grad norms differ")
    print(f"{what} kernel path against plain path, step 1's gradients from "
          f"the same weights: {len(leaves)} leaves, ||g - g_plain|| / "
          f"||g_plain|| worst {leaves[0][0]} {leaves[0][1]:.3e} (<= "
          f"{leaf_rtol:.3e}), then "
          + ", ".join(f"{p} {r:.2e}" for p, r in leaves[1:6]))
    check(leaves[0][1] <= leaf_rtol,
          f"{what} kernel/plain gradient leaf {leaves[0][0]} differs")
    return plain


def reordered_loss_drift(torch, model, settings, batch, plain) -> float:
    """|loss − plain["loss"]| / |plain["loss"]| of the plain path's loss
    (no gradient) from the same weights (seed 0) with its SSD's y sum in
    two halves (``reordered_ssd_chunk_ref``): the same function, rounded
    elsewhere, so the plain path's own noise at this depth."""
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import init_train_state

    dev = batch["tokens"].device
    params = init_train_state(model, settings,
                              torch.Generator(device=dev).manual_seed(0),
                              dev)["params"]
    saved, ref.ssd_chunk_ref = ref.ssd_chunk_ref, reordered_ssd_chunk_ref
    try:
        with torch.no_grad():
            loss = model.loss_fn(params, batch, mode="ref").item()
    finally:
        ref.ssd_chunk_ref = saved
    del params
    free_device_memory(torch)
    return abs(loss - plain["loss"]) / abs(plain["loss"])


def train_ssd_launches(rows) -> dict[str, int]:
    return {name: sum(r["launches"][name] for r in rows)
            for name in ("ssd_chunk", "ssd_chunk_bwd")}


def hybrid_train_phase(torch, dev, smi: str) -> dict:
    """Phase 18b: Zamba2-1.2B at full width and depth, bf16, batch 1 x
    TRAIN_SEQ, TRAIN_HYBRID_STEPS steps through K6, K7 and their
    backwards; step 1 held to the plain path; where a step's time goes,
    with the SSD's and the shared attention's shares.  Returns K7's and its
    backward's launches over the steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models import zamba2 as Z
    from repro_torch.models.api import get_model

    cfg = get_config(TRAIN_HYBRID_ARCH)
    model = get_model(cfg)
    settings = TrainSettings()
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(torch, dev, cfg, 1,
                        torch.Generator(device=dev).manual_seed(1))
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    print(f"{TRAIN_HYBRID_ARCH}: {cfg.n_layers} Mamba2 layers and "
          f"{Z.n_shared_invocations(cfg)} shared-attention invocations, "
          f"{n_params / 1e9:.3f} B parameters, bf16, batch 1 x {TRAIN_SEQ}, "
          f"remat {cfg.remat} ({cfg.remat_policy}) on the Mamba2 layers")
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_HYBRID_STEPS, TRAIN_HYBRID_ARCH)
    peak = torch.cuda.max_memory_allocated()
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{TRAIN_HYBRID_ARCH} train step (profiled)", busy,
                  host_ms, prof_rows)
    del state, step
    plain = plain_path_step1(torch, model, settings, batch, rows,
                             TRAIN_HYBRID_ARCH, TRAIN_HYBRID_LOSS_RTOL)
    print(f"the plain path's own noise: its step-1 loss with the SSD's y sum "
          f"in two halves (reordered_ssd_chunk_ref) moves by "
          f"{reordered_loss_drift(torch, model, settings, batch, plain):.3e}"
          f" relative (the loss bar {TRAIN_HYBRID_LOSS_RTOL:g}, ROADMAP F4)")
    # the SSD of one Mamba2 layer and the shared block's attention (K6 and
    # its backward, and its plain version) at the step's shapes, alone,
    # each forward and backward; the Mamba layers recompute their forward
    # (remat), the shared block does not
    ssd_line, ssd, plain_ssd = ssd_train_ms(torch, dev, cfg)
    line, attn, _ = attention_train_ms(torch, dev, cfg,
                                       Z.n_shared_invocations(cfg), False)
    print(ssd_line)
    print(f"the shared block's {line}")
    k6_ms = step_rows_ms(prof_rows, busy, "K6 and its backward", K6_ROWS)
    k7_ms = step_rows_ms(prof_rows, busy, "K7 and its backward", K7_ROWS)
    print(f"{TRAIN_HYBRID_ARCH} train on {smi}: {host_ms:.1f} ms/step "
          f"(batch 1 x {TRAIN_SEQ}), device busy {busy:.1f} ms, peak "
          f"{peak / 1e9:.3f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_HYBRID_STEPS} steps; K6 and "
          f"its backward {100 * k6_ms / busy:.1f}% and K7 and its backward "
          f"{100 * k7_ms / busy:.1f}% of the profiled step's device busy; "
          f"the SSD {ssd:.1f} ms on the kernels, {plain_ssd:.1f} ms on its "
          f"plain version, composed from the SSD alone (an estimate)")
    check(peak < 80e9, f"{TRAIN_HYBRID_ARCH} train peak {peak / 1e9:.3f} GB")
    free_device_memory(torch)
    return {"launches": train_ssd_launches(rows), "steps": TRAIN_HYBRID_STEPS,
            "ms_per_step": host_ms, "busy_ms": busy, "k7_share": k7_ms / busy}


def ssm_train_phase(torch, dev, smi: str) -> dict:
    """Phase 18c: mamba2-2.7b at full width and depth, bf16, remat, batch
    1 x TRAIN_SEQ, TRAIN_SSM_STEPS AdamW steps through K7 and its backward
    (and K4/K5): the dry-run's predicted peak first (``launch.dryrun`` on
    the meta device), then the steps (the loss finite and falling, the
    launches ``train_launches`` counts, no plain version reached), the
    peak against 80 GB and the prediction, and a profiled step."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models.api import get_model

    cfg = get_config(SSM_ARCH)
    model = get_model(cfg)
    settings = TrainSettings()
    t0 = time.perf_counter()
    pred = dryrun.run_cell(SSM_ARCH, ShapeSpec("train", TRAIN_SEQ, 1, "train"),
                           settings=settings)
    check(pred["ok"], f"{SSM_ARCH} train dry-run: {pred.get('error')}")
    launched = {k: v for k, v in pred["kernel_launches"].items() if v}
    print(f"{SSM_ARCH}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, state "
          f"{cfg.ssm_state}, {cfg.ssm_groups} B/C group; bf16, batch 1 x "
          f"{TRAIN_SEQ}, remat {cfg.remat} ({cfg.remat_policy}); dry-run on "
          f"meta ({time.perf_counter() - t0:.1f} s): peak "
          f"{pred['peak_memory_per_device'] / 1e9:.3f} GB predicted, step's "
          f"{pred['step_peak_bytes'] / 1e9:.3f} GB, launches {launched}, "
          f"bound {1e3 * max(pred['compute_s'], pred['memory_s']):.3f} ms "
          f"({pred['bottleneck']})", flush=True)
    check(cfg.remat, f"{SSM_ARCH} trains with remat")
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(torch, dev, cfg, 1,
                        torch.Generator(device=dev).manual_seed(1))
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_SSM_STEPS, SSM_ARCH)
    peak = torch.cuda.max_memory_allocated()
    print(f"{SSM_ARCH}: {n_params / 1e9:.3f} B parameters; measured peak "
          f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated; < 80 GB), "
          f"predicted {pred['peak_memory_per_device'] / 1e9:.3f} GB")
    check(peak < 80e9, f"{SSM_ARCH} train peak {peak / 1e9:.3f} GB >= 80 GB")
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{SSM_ARCH} train step (profiled; host ms the median of "
                  f"steps 2-{TRAIN_SSM_STEPS})", busy, host_ms, prof_rows)
    k7_ms = step_rows_ms(prof_rows, busy, "K7 and its backward", K7_ROWS)
    del state, step
    free_device_memory(torch)
    print(f"{SSM_ARCH} train on {smi}: {host_ms:.1f} ms/step (batch 1 x "
          f"{TRAIN_SEQ}), device busy {busy:.1f} ms, peak {peak / 1e9:.3f} "
          f"GB; loss {rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f} over "
          f"{TRAIN_SSM_STEPS} steps; K7 and its backward "
          f"{100 * k7_ms / busy:.1f}% of the profiled step's device busy")
    return {"launches": train_ssd_launches(rows), "steps": TRAIN_SSM_STEPS,
            "ms_per_step": host_ms, "busy_ms": busy, "k7_share": k7_ms / busy}


# ------------------------------------------------------- phases 18d-18f

class FamilyTrain(NamedTuple):
    """A train path of phases 18d-18f: ``arch`` at full width, ``layers``
    deep (None: the config's depth), ``batch`` rows of TRAIN_SEQ positions
    (the reference's train inputs) in ``microbatches``; its fp32 twin
    ``fp32_layers`` deep (the encoder's and the decoder's alike)."""
    phase: str
    arch: str
    batch: int
    microbatches: int
    layers: int | None
    fp32_layers: int
    loss_rtol: float = TRAIN_LOSS_RTOL
    leaf_rtol: float = TRAIN_LEAF_RTOL


TRAIN_MOE_ARCH = "granite-moe-1b-a400m"
# qwen2-vl-72b trains cut to the most layers whose step the dry-run on meta
# puts under 72 GB: 2 (67.9 GB; 3 are 79.4 GB), its embedding and head 1.25 B
# parameters each, a layer 0.88 B, 12 bytes of state a parameter
VLM_TRAIN_LAYERS = 2
# step 1's bars where phase 18's lie under the plain path's own noise
# (ROADMAP F5): twice the largest move of the plain path's loss, or of a
# gradient leaf, when its attention is the reference's chunked attention at
# the reference's own 1024-key chunks (``chunked_plain_attention``), over
# batches 1-5 of the cell (tools/train_loss_noise.py; the readings in
# PERF.md §7): seamless-m4t-large-v2's loss 1.763e-5 (batch 4) and its
# leaves 5.525e-2 (batch 1, /decoder/ln_x/scale), qwen2-vl-72b's loss
# 3.490e-5 (batch 3); granite-moe-1b-a400m keeps phase 18's bars
ENCDEC_TRAIN_LOSS_RTOL = 2 * 1.763e-5
ENCDEC_TRAIN_LEAF_RTOL = 2 * 5.525e-2
VLM_TRAIN_LOSS_RTOL = 2 * 3.490e-5
# the fp32 twins: 4 layers, the VLM's 1 (in fp32 its two 152064 x 8192
# tables and a layer are 13.5 GB, held with both paths' gradients)
TRAIN_FAMILIES = (FamilyTrain("18d", TRAIN_MOE_ARCH, 2, 2, None, 4),
                  FamilyTrain("18e", ENCDEC_ARCH, 2, 2, None, 4,
                              ENCDEC_TRAIN_LOSS_RTOL, ENCDEC_TRAIN_LEAF_RTOL),
                  FamilyTrain("18f", VLM_ARCH, 1, 1, VLM_TRAIN_LAYERS, 1,
                              VLM_TRAIN_LOSS_RTOL))
TRAIN_FAMILY_STEPS = 3
# the fp32 twin's kernel path against its plain path: fp32 order
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_LEAF_RTOL = 1e-4


def family_label(ft: FamilyTrain) -> str:
    return (f"{ft.arch} train {ft.batch}x{TRAIN_SEQ}"
            + (f" {ft.layers} layers" if ft.layers else ""))


def family_config(ft: FamilyTrain):
    from repro_torch.configs import get_config

    cfg = get_config(ft.arch)
    return cfg.replace(n_layers=ft.layers) if ft.layers else cfg


def flash_rounded_attention_ref(q, k, v, causal=True, window=0,
                                chunk=None):
    """The plain version of K6 rounded where the reference's chunked
    attention rounds (its ``_flash_fwd_core`` over key chunks of ``chunk``,
    None: one chunk): each chunk's exp(s − running max) rounded to v's
    dtype before its PV product, the running sums rescaled and the output
    normalised in fp32, masked scores at -1e30, where
    ``ref.flash_attention_ref`` (the reference's ``_sdpa``) rounds the
    normalised softmax.  The reference takes either by its score size, so
    the same function, rounded elsewhere."""
    import math

    import torch

    from repro_torch.kernels import ref

    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    ref.check_causal_lengths(sq, sk, causal, window)
    qg = q.float().reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = ref.attention_mask(sq, sk, window, q.device)
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    m = torch.full(s.shape[:-1] + (1,), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (d,), device=q.device)
    step = chunk or sk
    for j in range(0, sk, step):
        sj = s[..., j:j + step]
        m_new = torch.maximum(m, sj.amax(dim=-1, keepdim=True))
        p = torch.exp(sj - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgqm,bkmd->bkgqd", p.to(v.dtype).float(),
            v[:, :, j:j + step].float())
        m = m_new
    return (acc / l).reshape(b, h, sq, d).to(q.dtype)


# the key chunk of the plain path's noise witness: the reference's own
# ``_SDPA_CHUNK``, which its attention takes past ``_CHUNKED_SDPA_THRESHOLD``
WITNESS_CHUNK = 1024


def reference_chunked_attention(chunk=None):
    """A stand-in for ``ref.flash_attention_ref`` (what ``mode="ref"``
    runs) that is the reference's chunked attention in plain PyTorch (its
    ``_sdpa_chunked_causal``: ``_flash_fwd_core``'s forward over key
    chunks of ``chunk``, ``flash_rounded_attention_ref``, and
    ``_sdpa_chunked_bwd``'s backward, ``ref.flash_attention_bwd_ref``,
    from the forward's lse) under any mask: the plain path's attention as
    a function, rounded where the reference's other path rounds it (dS,
    not p and dP, to bf16)."""
    import torch

    from repro_torch.kernels import ref

    scores, backward = ref._scores, ref.flash_attention_bwd_ref

    class Chunked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            o = flash_rounded_attention_ref(q, k, v, causal, window, chunk)
            b, h, sq, _ = q.shape
            lse = torch.logsumexp(scores(q, k, causal, window),
                                  dim=-1).reshape(b, h, sq)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.mask = (causal, window)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return (*backward(q, k, v, o, do.contiguous(), lse, *ctx.mask),
                    None, None)

    return lambda q, k, v, causal=True, window=0: Chunked.apply(
        q, k, v, causal, window)


@contextlib.contextmanager
def chunked_plain_attention(chunk: int = WITNESS_CHUNK):
    """Inside the block, ``mode="ref"`` attends through
    ``reference_chunked_attention(chunk)``; ``ref.flash_attention_ref`` is
    restored after it, also after a raise."""
    from repro_torch.kernels import ref

    saved = ref.flash_attention_ref
    ref.flash_attention_ref = reference_chunked_attention(chunk)
    try:
        yield
    finally:
        ref.flash_attention_ref = saved


def moe_step1_repeats(torch, model, params, batch, microbatches: int
                      ) -> bool:
    """Step 1's loss and gradients on the kernel path taken twice from the
    same weights and batch, each running free: bit for bit equal, or the
    leaves that differ (printed)."""
    la, ga = step_grads(model, params, batch, microbatches)
    lb, gb = step_grads(model, params, batch, microbatches)
    differ = [(path, (x.float() - y.float()).abs().max().item(),
               y.float().abs().max().item())
              for (path, x), (_, y) in zip(_paths(ga), _paths(gb))
              if not torch.equal(x, y)]
    same = torch.equal(la, lb) and not differ
    print(f"{TRAIN_MOE_ARCH} step 1 run twice from the same state, kernel "
          f"path: loss {la.item():.9g} vs {lb.item():.9g}, "
          + ("every gradient leaf bit-identical" if same else
             f"{len(differ)} of {len(list(_paths(ga)))} gradient leaves "
             f"differ: " + ", ".join(f"{p} max |d| {a:.3e} of {m:.3e}"
                                     for p, a, m in differ[:8])))
    del ga, gb
    return same


def fp32_twin(torch, dev, ft: FamilyTrain, cfg) -> None:
    """The path's fp32 twin: ``cfg`` in fp32, ``ft.fp32_layers`` deep, from
    seeded weights and the same batch (its embeddings in fp32): step 1's
    loss and gradients on the kernel path (the launches ``train_launches``
    counts, no plain version reached) against the plain path's, the loss
    within TRAIN_FP32_LOSS_RTOL and each leaf within TRAIN_FP32_LEAF_RTOL
    of its norm; the MoE's plain path replays the kernel path's choices."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model

    over = {"dtype": "float32", "param_dtype": "float32",
            "n_layers": min(ft.fp32_layers, cfg.n_layers)}
    if cfg.family == "encdec":
        over["n_encoder_layers"] = min(ft.fp32_layers, cfg.n_encoder_layers)
    cfg32 = cfg.replace(**over)
    model = get_model(cfg32)
    free_device_memory(torch)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(torch, dev, cfg32, ft.batch,
                        torch.Generator(device=dev).manual_seed(1))
    choices = ExpertChoices()
    moe = cfg.family == "moe"
    ops.reset_launches()
    with PlainSpy(TRAIN_PLAIN_FNS) as spy:
        lk, gk = step_grads(model, params, batch, ft.microbatches, None,
                            choices.record if moe else contextlib.nullcontext)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = train_launches(cfg32, ft.microbatches, True)
    lp, gp = step_grads(model, params, batch, ft.microbatches, "ref",
                        choices.replay if moe else contextlib.nullcontext)
    leaves = leaf_errors(gk, gp)
    del gk, gp, params
    free_device_memory(torch)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    got = {name: launches[name] for name in expected}
    print(f"{ft.arch} fp32 twin ({cfg32.n_layers} layers"
          + (f" + {cfg32.n_encoder_layers} encoder"
             if cfg.family == "encdec" else "")
          + f", full width{', the plain path replaying the expert choices' if moe else ''}"
          f"), step 1 kernel path against plain path: loss {lk.item():.9g} "
          f"vs {lp.item():.9g} (rel {loss_rel:.3e} <= "
          f"{TRAIN_FP32_LOSS_RTOL:g}); {len(leaves)} leaves, worst "
          f"{leaves[0][0]} {leaves[0][1]:.3e} (<= {TRAIN_FP32_LEAF_RTOL:g}); "
          f"launches {got} (expected {expected}); plain attention and SSD "
          f"reached {sum(spy.calls.values())} times")
    check(loss_rel <= TRAIN_FP32_LOSS_RTOL,
          f"{ft.arch} fp32 twin: kernel/plain losses differ")
    check(leaves[0][1] <= TRAIN_FP32_LEAF_RTOL,
          f"{ft.arch} fp32 twin: gradient leaf {leaves[0][0]} differs")
    check(got == expected and not any(spy.calls.values()),
          f"{ft.arch} fp32 twin: launches {got}, expected {expected}, plain "
          f"versions reached {spy.calls}")


def family_train_phase(torch, dev, smi: str, ft: FamilyTrain,
                       pred: dict) -> dict:
    """One of phases 18d-18f (module docstring): ``ft``'s path trained by
    ``build_train_step`` at full width in bf16 with fp32 AdamW moments and
    remat, TRAIN_FAMILY_STEPS steps from seeded weights on a seeded batch;
    its peak against 80 GB and ``pred`` (the dry-run of the same cell on
    meta); a profiled step; step 1 against the plain path (the MoE's plain
    path replaying the kernel path's expert choices, recorded by layer,
    forward and recompute); the fp32 twin.  Returns the launches and
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models.api import get_model

    cfg = family_config(ft)
    model = get_model(cfg)
    settings = TrainSettings(microbatches=ft.microbatches)
    moe = cfg.family == "moe"
    label = family_label(ft)
    check(pred.get("ok"), f"{label}: the dry-run ended {pred}")
    check(cfg.remat and cfg.remat_policy == "full",
          f"{ft.arch} trains with full remat")
    launched = {k: v for k, v in pred["kernel_launches"].items() if v}
    print(f"{label}: {cfg.family}, {cfg.n_layers} layers"
          + (f" of {get_config(ft.arch).n_layers}" if ft.layers else "")
          + (f" + {cfg.n_encoder_layers} encoder layers"
             if cfg.family == "encdec" else "")
          + f", d_model {cfg.d_model}, {cfg.n_heads} heads on "
          f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
          + (f"{cfg.n_experts} experts top-{cfg.experts_per_token} of "
             f"d_ff {cfg.moe_d_ff}, groups of {cfg.moe_group_size}, capacity "
             f"factor {cfg.capacity_factor}, " if moe else
             f"d_ff {cfg.d_ff}, ")
          + f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab}; bf16, fp32 "
          f"moments, remat {cfg.remat} ({cfg.remat_policy}); batch "
          f"{ft.batch} x {TRAIN_SEQ} in {ft.microbatches} microbatches; "
          f"dry-run on meta: peak {pred['peak_memory_per_device'] / 1e9:.3f} "
          f"GB predicted, launches {launched}, bound "
          f"{1e3 * max(pred['compute_s'], pred['memory_s']):.3f} ms "
          f"({pred['bottleneck']})", flush=True)
    free_device_memory(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    batch = train_batch(torch, dev, cfg, ft.batch,
                        torch.Generator(device=dev).manual_seed(1))
    choices = ExpertChoices()

    def step1_recorded(i):
        return choices.record() if moe and i == 0 else contextlib.nullcontext()

    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_FAMILY_STEPS, ft.arch, around=step1_recorded)
    peak = torch.cuda.max_memory_allocated() - before
    p_peak = pred["peak_memory_per_device"]
    print(f"{ft.arch}: {n_params / 1e9:.3f} B parameters; measured peak "
          f"{peak / 1e9:.3f} GB over {TRAIN_FAMILY_STEPS} steps (from the "
          f"state's making; < 80 GB), predicted {p_peak / 1e9:.3f} GB "
          f"({100 * (p_peak - peak) / peak:+.2f}%, within "
          f"{100 * DRY_PEAK_RTOL:g}%)")
    check(peak < 80e9, f"{ft.arch} train peak {peak / 1e9:.3f} GB >= 80 GB")
    check(abs(p_peak - peak) <= DRY_PEAK_RTOL * peak,
          f"{ft.arch} train peak {peak / 1e9:.3f} GB, predicted "
          f"{p_peak / 1e9:.3f} GB")
    if moe:
        differ = choices.recompute_differs()
        n_re = sum(k[1] == ExpertChoices.RECOMPUTE for k in choices.choices)
        print(f"{ft.arch} step 1: expert choices recorded by (layer, pass, "
              f"microbatch): {len(choices.choices) - n_re} forward, {n_re} "
              f"recompute; every recompute's choices bit-identical to its "
              f"forward's: {not differ}"
              + (f" (differ: {differ})" if differ else ""))
        check(n_re == cfg.n_layers * ft.microbatches and not differ,
              f"{ft.arch}: the remat recompute routed otherwise than the "
              f"forward at (layer, microbatch) {differ}")
    host = sorted(r["ms"] for r in rows[1:])
    host_ms = host[len(host) // 2]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{ft.arch} train step (profiled, one step; host ms the "
                  f"median of steps 2-{TRAIN_FAMILY_STEPS})", busy, host_ms,
                  prof_rows)
    k6_ms = step_rows_ms(prof_rows, busy, "K6 and its backward", K6_ROWS)
    xent = {n: sum(us for key, _, us in prof_rows if tag in key) / 1e3
            for n, tag in (("K4", "xent_fwd"), ("K4 mean", "xent_mean"),
                           ("K5", "xent_dlogits"))}
    rows_mb = (ft.batch // ft.microbatches) * (
        TRAIN_SEQ - TRAIN_SEQ // 2 if cfg.family == "encdec" else TRAIN_SEQ)
    print(f"K4/K5 at ({rows_mb}, {cfg.padded_vocab}) in the profiled step: "
          + ", ".join(
              f"{n} {ms:.4f} ms" for n, ms in xent.items())
          + f" = {100 * sum(xent.values()) / busy:.2f}% of device busy")
    del state, step
    free_device_memory(torch)

    replay = choices.replay if moe else contextlib.nullcontext
    if moe:
        params = init_train_state(model, settings,
                                  torch.Generator(device=dev).manual_seed(0),
                                  dev)["params"]
        repeat = moe_step1_repeats(torch, model, params, batch,
                                   ft.microbatches)
        free = ExpertChoices()
        micro = microbatched(batch, ft.microbatches)
        with torch.no_grad(), free.record():
            for i in range(ft.microbatches):
                model.loss_fn(params, {k: v[i] for k, v in micro.items()},
                              mode="ref")
        shares = [sum(f) / len(f) for f in zip(*(
            flip_shares(choices.by_layer(n=i), free.by_layer(n=i))
            for i in range(ft.microbatches)))]
        print(f"{ft.arch} step 1, the plain path running free (printed, not "
              f"held): expert choices that differ from the kernel path's, % "
              f"of tokens by layer: " + " ".join(f"{100 * f:.2f}"
                                                 for f in shares)
              + f"; all layers {100 * sum(shares) / len(shares):.2f}%")
        del free, params
        free_device_memory(torch)
    raised = (ft.loss_rtol, ft.leaf_rtol) != (TRAIN_LOSS_RTOL,
                                              TRAIN_LEAF_RTOL)
    plain = plain_path_step1(torch, model, settings, batch, rows, ft.arch,
                             ft.loss_rtol, ft.leaf_rtol, replay, raised)
    fp32_twin(torch, dev, ft, cfg)
    peak_gb = peak / 1e9
    print(f"{label} on {smi}: {host_ms:.1f} ms/step (batch {ft.batch} x "
          f"{TRAIN_SEQ}, {ft.microbatches} microbatches), device busy "
          f"{busy:.1f} ms, peak {peak_gb:.3f} GB (predicted "
          f"{p_peak / 1e9:.3f}); loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_FAMILY_STEPS} steps; K6 and its "
          f"backward {k6_ms:.1f} ms = {100 * k6_ms / busy:.1f}% and K4/K5 "
          f"{100 * sum(xent.values()) / busy:.2f}% of the profiled step's "
          f"device busy; plain step 1 host {plain['ms']:.1f} ms"
          + (f"; step 1 repeated bit-identical: {repeat}" if moe else ""))
    totals = {name: sum(r["launches"][name] for r in rows)
              for name in ("softmax_xent_fwd", "softmax_xent_dlogits",
                           "flash_attention", "flash_attention_bwd")}
    return {"launches": totals, "steps": TRAIN_FAMILY_STEPS,
            "ms_per_step": host_ms, "busy_ms": busy, "peak": peak,
            "k6_share": k6_ms / busy, "n_params": n_params}


def wait_predictions(predictor, out_dir: str) -> float:
    """Wait for phase 22's dry-runs on meta (``start_predictions``), which
    must end with 0; returns the seconds waited."""
    t0 = time.perf_counter()
    try:
        rc = predictor.wait(timeout=PREDICT_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    log = os.path.join(out_dir, "predict.log")
    if rc != 0:
        with open(log) as f:
            print(f.read()[-4000:])
    check(rc == 0, f"the dry-runs' process ended with {rc} (log: {log})")
    return time.perf_counter() - t0


def load_predictions(out_dir: str, name: str) -> dict:
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


def family_train_phases(torch, dev, smi: str, predictor) -> dict:
    """Phases 18d-18f: the MoE, encoder-decoder and VLM families trained
    at full width (TRAIN_FAMILIES), each held to the dry-run's prediction
    of its cell; returns each path's numbers by arch."""
    wait_predictions(predictor, PREDICT_DIR)
    cells = load_predictions(PREDICT_DIR, "cells.json")["cells"]
    out = {}
    for ft in TRAIN_FAMILIES:
        cfg = family_config(ft)
        phase(ft.phase, f"lm train: {family_label(ft)}, full width, "
                        f"{TRAIN_FAMILY_STEPS} AdamW steps through K4/K5, K6 "
                        f"and its backward, step 1 against the plain path, "
                        f"an fp32 twin of {min(ft.fp32_layers, cfg.n_layers)} "
                        f"layers")
        out[ft.arch] = family_train_phase(torch, dev, smi, ft,
                                          cells[family_label(ft)])
    return out


# phase 18g: Zamba2-1.2B in fp32 (weights, activations and the SSD and
# attention inputs), the one training cell that reaches the fp32 backwards
# of K6 and K7 at full width
TRAIN_FP32_STEPS = 2


def fp32_train_config():
    """Zamba2-1.2B at full width and depth in fp32, remat as configured."""
    from repro_torch.configs import get_config

    return get_config(TRAIN_HYBRID_ARCH).replace(dtype="float32",
                                                 param_dtype="float32")


def fp32_train_label() -> str:
    return f"{TRAIN_HYBRID_ARCH} train 1x{TRAIN_SEQ} fp32"


def fp32_hybrid_train_phase(torch, dev, smi: str, pred: dict | None = None
                            ) -> dict:
    """Phase 18g: ``fp32_train_config`` trained by ``build_train_step``,
    batch 1 x TRAIN_SEQ, TRAIN_FP32_STEPS AdamW steps from seeded weights:
    the dry-run on meta first (``pred``, phase 22's prediction of the same
    cell, or run here where None: its peak and launches), then the steps (the
    loss finite and falling, the launches ``train_launches`` counts, no
    plain version reached), the measured peak within DRY_PEAK_RTOL of the
    prediction, a profiled step with the shares of K6 and K7 with their
    backwards, and step 1 against the plain path at the fp32 twins' bars
    (loss TRAIN_FP32_LOSS_RTOL, each leaf TRAIN_FP32_LEAF_RTOL of its
    norm).  Returns the launches and the step's numbers, and under "card"
    what ``card_cell`` measures of a cell (the peak of the state made after
    the reset, the steps' own, step 1's launches, loss and gradient norm,
    the profiled step's busy time), which phase 22 holds to the same
    prediction in place of a step of its own."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (TrainSettings, build_train_step,
                                          init_train_state)
    from repro_torch.models import zamba2 as Z
    from repro_torch.models.api import get_model

    what = fp32_train_label()
    cfg = fp32_train_config()
    model = get_model(cfg)
    settings = TrainSettings()
    source = "phase 22's"
    if pred is None:
        t0 = time.perf_counter()
        pred = dryrun.run_cell(TRAIN_HYBRID_ARCH,
                               ShapeSpec("train", TRAIN_SEQ, 1, "train"),
                               cfg=cfg, settings=settings)
        source = f"{time.perf_counter() - t0:.1f} s"
    check(pred["ok"], f"{what} dry-run: {pred.get('error')}")
    launched = {k: v for k, v in pred["kernel_launches"].items() if v}
    print(f"{what}: {cfg.n_layers} Mamba2 layers and "
          f"{Z.n_shared_invocations(cfg)} shared-attention invocations, "
          f"remat {cfg.remat} ({cfg.remat_policy}); dry-run on meta "
          f"({source}): peak "
          f"{pred['peak_memory_per_device'] / 1e9:.3f} GB predicted, step's "
          f"{pred['step_peak_bytes'] / 1e9:.3f} GB, launches {launched}, "
          f"bound {1e3 * max(pred['compute_s'], pred['memory_s']):.3f} ms "
          f"({pred['bottleneck']})", flush=True)
    free_device_memory(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, settings,
                             torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(torch, dev, cfg, 1,
                        torch.Generator(device=dev).manual_seed(1))
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    state, rows = run_train(torch, model, settings, state, batch,
                            TRAIN_FP32_STEPS, what)
    step_peak = torch.cuda.max_memory_allocated() - before
    peak = max(setup_peak, step_peak)
    p_peak = pred["peak_memory_per_device"]
    print(f"{what}: {n_params / 1e9:.3f} B parameters; measured peak "
          f"{peak / 1e9:.3f} GB above the {before / 1e9:.3f} GB held before "
          f"(torch.cuda.max_memory_allocated), predicted {p_peak / 1e9:.3f} "
          f"GB ({100 * (p_peak - peak) / peak:+.2f}%, within "
          f"{100 * DRY_PEAK_RTOL:g}%)")
    check(abs(p_peak - peak) <= DRY_PEAK_RTOL * peak,
          f"{what}: measured peak {peak / 1e9:.3f} GB, predicted "
          f"{p_peak / 1e9:.3f} GB")
    check(pred["kernel_launches"] == rows[0]["launches"],
          f"{what}: launches {rows[0]['launches']}, predicted "
          f"{pred['kernel_launches']}")
    host_ms = rows[-1]["ms"]
    step = build_train_step(model, settings)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy, prof_rows = profile_train_step(torch, one_step)
    print_profile(f"{what} step (profiled; host ms step "
                  f"{TRAIN_FP32_STEPS}'s)", busy, host_ms, prof_rows)
    k6_ms = step_rows_ms(prof_rows, busy, "K6 and its backward", K6_ROWS)
    k7_ms = step_rows_ms(prof_rows, busy, "K7 and its backward", K7_ROWS)
    del state, step
    plain_path_step1(torch, model, settings, batch, rows, what,
                     TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_LEAF_RTOL)
    free_device_memory(torch)
    print(f"{what} on {smi}: {host_ms:.1f} ms/step, device busy {busy:.1f} "
          f"ms, peak {peak / 1e9:.3f} GB; loss {rows[0]['loss']:.4f} -> "
          f"{rows[-1]['loss']:.4f} over {TRAIN_FP32_STEPS} steps; K6 and its "
          f"backward {k6_ms:.3f} ms ({100 * k6_ms / busy:.1f}%), K7 and its "
          f"backward {k7_ms:.3f} ms ({100 * k7_ms / busy:.1f}%) of the "
          f"profiled step's device busy")
    return {"launches": {name: sum(r["launches"][name] for r in rows)
                         for name in rows[0]["launches"]},
            "steps": TRAIN_FP32_STEPS, "ms_per_step": host_ms,
            "busy_ms": busy, "peak": peak, "k6_ms": k6_ms, "k7_ms": k7_ms,
            "card": {"peak": peak, "step_peak": step_peak, "before": before,
                     "launches": rows[0]["launches"], "busy_ms": busy,
                     "ops": sum(c for _, c, _ in prof_rows),
                     "loss": rows[0]["loss"],
                     "grad_norm": rows[0]["grad_norm"]}}


def train_path_phase(torch, dev, smi: str, predictor) -> dict:
    """Phases 18-18c and 18g (its dry-run from phase 22's ``predictor``);
    returns K4/K5's launches and numbers on the train path, K7's and its
    backward's under "hybrid" and "ssm", 18g's under "fp32"."""
    phase(18, f"lm train: {TRAIN_ARCH} full width, {TRAIN_STEPS} AdamW steps "
              f"(2 microbatches of {TRAIN_SEQ} tokens), {TRAIN_INT8_STEPS} "
              f"with int8 error feedback, kernel path against plain path")
    out = granite_train_phase(torch, dev, smi)
    phase("18b", f"lm train: {TRAIN_HYBRID_ARCH} full width, "
                 f"{TRAIN_HYBRID_STEPS} steps through K6, K7 and their "
                 f"backwards, step 1 against the plain path")
    out["hybrid"] = hybrid_train_phase(torch, dev, smi)
    phase("18c", f"lm train: {SSM_ARCH} full width and depth, remat, "
                 f"{TRAIN_SSM_STEPS} steps through K7 and its backward")
    out["ssm"] = ssm_train_phase(torch, dev, smi)
    phase("18g", f"lm train: {fp32_train_label()}, full width and depth, "
                 f"{TRAIN_FP32_STEPS} steps through the fp32 K6, K7 and "
                 f"their backwards, step 1 against the plain path")
    wait_predictions(predictor, PREDICT_DIR)
    cells = load_predictions(PREDICT_DIR, "cells.json")["cells"]
    out["fp32"] = fp32_hybrid_train_phase(torch, dev, smi,
                                          cells[fp32_train_label()])
    return out


# ------------------------------------------------------- phases 19-21

ELASTIC_DEVICES = 8     # the serving runner's logical ring (phase 19)
# phase 20: a prompt past Zamba2-1.2B's attn_window (32,768) by 1,024
# tokens, 264 SSM chunks of 128; all but its last LONG_TAIL tokens (263
# chunks) are prefilled, then LONG_DECODE tokens decoded teacher-forced
# through the KV ring
LONG_PROMPT = 33_792
LONG_TAIL = 128
LONG_DECODE = 16
# phase 21: the training driver's runs of 6 steps, a checkpoint every 3
DRIVER_STEPS = 6
DRIVER_CKPT_EVERY = 3
DRIVER_LOSS_RTOL = 1e-5
# phase 21 drives granite-3-2b at full width cut to this many of its 40
# layers, so that the script stays within its earlier running time with
# phases 18d-18f added: the full model's 25.3 GB checkpoint took ~120 s of
# writes and restores
DRIVER_LAYERS = 10


def replay_logits(torch, runner, slot: int, prompt, tokens) -> list:
    """The fp32 logits row of ``slot`` at each generated position of a
    stream: ``prompt`` prefilled into ``slot`` of ``runner``'s fresh cache,
    then ``tokens`` (all but the last) decoded teacher-forced with every
    other slot idle, at the runner's batch (its slot count)."""
    rows = []
    with torch.inference_mode():
        logits, one = runner.model.prefill(
            runner.params, {"tokens": runner._tokens(prompt)[None, :]},
            runner.max_len)
        runner._merge(one, slot)
        rows.append(logits[0, -1].float())
        for t in tokens[:-1]:
            last = torch.zeros((runner.n_slots, 1), dtype=torch.int64,
                               device=runner.device)
            last[slot, 0] = int(t)
            logits, runner.cache = runner.model.decode_step(
                runner.params, runner.cache, {"tokens": last})
            rows.append(logits[slot, -1].float())
    return rows


def elastic_serve_phase(torch, dev, smi: str) -> dict[str, int]:
    """Phase 19: Zamba2-1.2B served at full width under the
    ``device-loss-mid-decode`` preset (2 of ELASTIC_DEVICES logical devices
    lost at decode step 4) through ``launch.serve.serve`` and its
    ServeAutoscaler, and the same trace with no fault; returns the fault
    run's K6/K7 launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report_lines, serve
    from repro_torch.serve import ServeAutoscaler, WallClock

    runs = {}
    for name, over in (("fault", {}), ("no fault", {"device_loss": None})):
        free_device_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        result = serve(ARCH, scenario="device-loss-mid-decode", n_requests=8,
                       prompt_buckets=SERVE_BUCKETS, slots=4, seed=0,
                       device=dev, clock=WallClock(),
                       n_devices=ELASTIC_DEVICES, **over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        sc, slo = result.scenario, result.slo
        print(f"[{name}]")
        for line in report_lines(result, 0, 4):
            print(line)
        n_prefill = result.n_prefills + len(sc.prompt_buckets)  # + warmup
        per = launches_per_prefill(result.cfg)
        print(f"  {result.n_prefills} prefills ({slo.n_restarts} restarted) "
              f"+ {len(sc.prompt_buckets)} warmup, {result.n_decode_steps} "
              f"decode steps; launches {launches}; wall {wall:.2f} s; peak "
              f"device memory {peak / 1e9:.3f} GB")
        check(slo.n_finished == sc.n_requests,
              f"{name}: served {slo.n_finished}/{sc.n_requests} requests")
        check(peak < 80e9, f"{name}: peak {peak / 1e9:.3f} GB >= 80 GB")
        for k in LM_KERNELS:
            check(launches[k] == per[k] * n_prefill,
                  f"{name}: {k} launched {launches[k]} times, expected "
                  f"{per[k]} per prefill x {n_prefill}")
        runs[name] = (result, launches)
    fault, clean = runs["fault"][0], runs["no fault"][0]
    check(len(fault.replans) == 1 and not clean.replans,
          f"replans: {len(fault.replans)} under the fault, "
          f"{len(clean.replans)} without")
    rp = fault.replans[0]
    want = ServeAutoscaler(ELASTIC_DEVICES, 4).on_device_loss(2, rp.at_s)
    print(f"decision: {rp.reason} devices {rp.from_devices} -> "
          f"{rp.to_devices}, slots {rp.from_slots} -> {rp.to_slots}, "
          f"epoch_s {rp.epoch_s!r}, lemma1_cores {rp.lemma1_cores}; "
          f"restarts {fault.slo.n_restarts}")
    check(rp == want and (rp.from_devices, rp.to_devices) == (8, 6)
          and fault.n_devices == 6,
          f"the decision {rp} differs from the autoscaler's {want}")
    check(fault.slo.n_restarts >= 1, "the device loss restarted no request")
    check(set(fault.streams) == set(clean.streams), "the rids differ")
    for name, res in (("fault", fault), ("no fault", clean)):
        s = res.slo
        print(f"{name}: TTFT p50/p99 {s.p50_ttft_s * 1e3:.1f}/"
              f"{s.p99_ttft_s * 1e3:.1f} ms, TPOT p50/p99 "
              f"{s.p50_tpot_s * 1e3:.2f}/{s.p99_tpot_s * 1e3:.2f} ms, "
              f"{s.throughput_tok_s:.1f} tok/s on {smi}")
    # the slots change (4 -> to_slots), so the decode GEMMs' batch does, and
    # bf16 may round a row otherwise: a stream that differs is held to
    # phase 9's greedy-token rule at its first differing token, from the
    # logits of both batches replayed
    check_differing_streams(torch, dev, fault, clean)
    return dict(runs["fault"][1])


def check_differing_streams(torch, dev, fault, clean) -> None:
    """Phase 19's streams under the fault against the no-fault run's: each
    one that differs is replayed at both decode batches (4 slots, and the
    replan's) from its prompt and the common prefix, and at its first
    differing token the top-2 gap of the no-fault logits must not exceed
    twice the two batches' logit difference."""
    from repro_torch.configs import get_config
    from repro_torch.serve import (TorchModelRunner, make_traffic,
                                   prompt_tokens)

    rp = fault.replans[0]
    differ = sorted(r for r in clean.streams
                    if fault.streams[r] != clean.streams[r])
    print(f"streams differing from the no-fault run: {len(differ)} of "
          f"{len(clean.streams)}")
    if differ:
        cfg = get_config(ARCH)
        trace = make_traffic(fault.scenario, 0)
        events = {ev.rid: ev for ev in trace.events}
        runners = {m: TorchModelRunner(cfg, n_slots=m,
                                       max_len=fault.scenario.max_len,
                                       device=dev)
                   for m in (4, rp.to_slots)}
        for rid in differ:
            a, b = clean.streams[rid], fault.streams[rid]
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            prompt = prompt_tokens(trace.seed, events[rid], cfg.vocab_size)
            runners[4]._build(4)
            runners[rp.to_slots]._build(rp.to_slots)
            lc = replay_logits(torch, runners[4], 0, prompt, a[:j + 1])[j]
            lf = replay_logits(torch, runners[rp.to_slots], 0, prompt,
                               b[:j + 1])[j]
            diff = (lc - lf).abs().max().item()
            top2 = torch.topk(lc, 2).values
            gap = (top2[0] - top2[1]).item()
            print(f"  request {rid}: first difference at token {j} ({a[j]} "
                  f"vs {b[j]}); replayed at 4 and {rp.to_slots} slots: "
                  f"tokens {int(lc.argmax())} and {int(lf.argmax())}, max "
                  f"|dlogit| {diff:.4e}, top-2 gap {gap:.4e}")
            check(gap <= 2 * diff,
                  f"request {rid}: the streams differ where the top-2 gap "
                  f"{gap:.4e} exceeds twice the logit difference {diff:.4e}")
        del runners
        free_device_memory(torch)


LONG_K6_ROWS = 128      # query rows a slice of phase 20's K6 check: a bf16 tile


def windowed_rows_ref(torch, q, k, v, q0: int, q1: int, window: int):
    """Query rows [q0, q1) of ``ref.flash_attention_ref(q, k, v, True,
    window)`` in its arithmetic (fp32 scores and softmax, probabilities
    rounded to v's dtype before the PV product, GQA by head grouping),
    reading only the keys [q0 - window + 1, q1) that the window keeps: the
    plain version at a length whose whole score matrix does not fit."""
    lo = max(0, q0 - window + 1)
    b, h, _, d = q.shape
    kv = k.shape[1]
    qg = q[:, :, q0:q1].float().reshape(b, kv, h // kv, q1 - q0, d)
    ks, vs = k[:, :, lo:q1], v[:, :, lo:q1]
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, ks.float()) / d ** 0.5
    iq = torch.arange(q0, q1, device=q.device)[:, None]
    ik = torch.arange(lo, q1, device=q.device)[None, :]
    s = s.masked_fill(~((ik <= iq) & (ik > iq - window)), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqm,bkmd->bkgqd", p.to(vs.dtype).float(), vs.float())
    return o.reshape(b, h, q1 - q0, d).to(q.dtype)


def check_long_k6(torch, dev, q, k, v, window: int) -> tuple[float, float]:
    """K6 at phase 20's inputs against its plain version on every query
    row, a LONG_K6_ROWS-row slice at a time (windowed_rows_ref, first held
    to the whole ``flash_attention_ref`` at a small shape), at phase 7's
    bf16 bars.  Returns (max abs error, host ms of the plain slices)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(7)
    small = [torch.randn(1, 32, 1024, 64, generator=gen, device=dev)
             for _ in range(3)]
    for w in (1, 129, 1000):
        whole = ref.flash_attention_ref(*small, True, w)
        rows = torch.cat([windowed_rows_ref(torch, *small, q0, q0 + 128, w)
                          for q0 in range(0, 1024, 128)], dim=2)
        a, r = errors(rows, whole)
        check(r <= 1e-6, f"sliced plain K6 against the whole one at window "
                         f"{w}: {r:.3e} of the largest output > 1e-6")
    print("sliced plain K6 = flash_attention_ref within 1e-6 of the largest "
          "output (fp32 (1, 32, 1024, 64), windows 1, 129, 1000)")
    del small, whole, rows
    out = flash_attention(q, k, v, True, window)
    n = q.shape[2]
    worst, plain_s = 0.0, 0.0
    shown = {0, window - LONG_K6_ROWS, window, window + LONG_K6_ROWS,
             (n - 1) // LONG_K6_ROWS * LONG_K6_ROWS}
    qf, kf, va = q.float(), k.float(), v.float().abs()    # for the slack
    with torch.inference_mode():
        for q0 in range(0, n, LONG_K6_ROWS):
            q1 = min(n, q0 + LONG_K6_ROWS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = windowed_rows_ref(torch, q, k, v, q0, q1, window)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            ok, a, crit = _close(
                torch, out[:, :, q0:q1], want, K6_FP32_RTOL,
                lambda: BF16_ULP * windowed_rows_ref(
                    torch, qf, kf, va, q0, q1, window))
            worst = max(worst, a)
            if q0 in shown or not ok:
                print(f"  rows {q0}-{q1 - 1} (keys from "
                      f"{max(0, q0 - window + 1)}): max abs {a:.3e}, {crit}")
            check(ok, f"K6 at the long prefill's rows {q0}-{q1 - 1}: {crit}")
    print(f"K6 at the long prefill's inputs: all {n} query rows within phase "
          f"7's bf16 bars in {-(-n // LONG_K6_ROWS)} slices, max abs error "
          f"{worst:.3e}; the plain slices {plain_s * 1e3:.1f} ms")
    del out, qf, kf, va
    return worst, plain_s * 1e3


def long_prefill_phase(torch, dev, smi: str) -> tuple[dict[str, int], dict]:
    """Phase 20: Zamba2-1.2B (bf16, full width) prefills LONG_PROMPT -
    LONG_TAIL tokens, past its attn_window, through the serving runner's
    model (K6 windowed), then decodes LONG_DECODE tokens teacher-forced
    through the KV ring; each step's logits are held to ``forward`` over
    the whole prompt at that position, and K6 to its plain version on the
    prefill's own inputs.  Returns the prefill's launches and K6's numbers
    at its shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve import TorchModelRunner

    cfg = get_config(ARCH)
    n_pre = LONG_PROMPT - LONG_TAIL
    check(LONG_PROMPT == cfg.attn_window + 1024
          and LONG_PROMPT % cfg.ssm_chunk == n_pre % cfg.ssm_chunk == 0,
          f"{LONG_PROMPT} and {n_pre} are not attn_window + 1024 and the "
          f"prefill in whole SSM chunks")
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    runner = TorchModelRunner(cfg, n_slots=1, max_len=LONG_PROMPT + 1,
                              device=dev)
    model, params = runner.model, runner.params
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT), generator=gen,
                           device=dev)
    batch = {"tokens": tokens[:, :n_pre]}
    # the warm prefill keeps the inputs of its first K6 call, strides and all
    captured = []
    kernel_call = ops.flash_attention

    def keep_first(q, k, v, *args, **kw):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), kw))
        return kernel_call(q, k, v, *args, **kw)

    with torch.inference_mode():
        ops.flash_attention = keep_first
        try:
            model.prefill(params, batch, runner.max_len)       # warm
        finally:
            ops.flash_attention = kernel_call
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, runner.max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch, runner.max_len)
            torch.cuda.synchronize()
    per = launches_per_prefill(cfg)
    print(f"{ARCH}: a {n_pre}-token prefill ({n_pre // cfg.ssm_chunk} "
          f"chunks) past attn_window {cfg.attn_window}: {prefill_ms:.1f} ms "
          f"host (profiler off); launches {launches}")
    for k in LM_KERNELS:
        check(launches[k] == per[k], f"{k} launched {launches[k]} times in "
                                     f"the long prefill, expected {per[k]}")
    check(tuple(cache["k"].shape[2:3]) == (cfg.attn_window,)
          and cache["len"].tolist() == [n_pre],
          f"the ring holds {tuple(cache['k'].shape)}, len "
          f"{cache['len'].tolist()}")
    rows = device_rows(prof)
    if rows:
        busy = sum(us for _, _, us in rows) / 1e3
        k6 = sum(us for k, _, us in rows if "flash_fwd" in k) / 1e3
        k7 = sum(us for k, _, us in rows if "ssd_chunk" in k) / 1e3
        print(f"device busy {busy:.3f} ms ({100 * busy / prefill_ms:.1f}% of "
              f"the profiler-off prefill); K6 {k6:.3f} ms in "
              f"{per['flash_attention']} calls ({100 * k6 / busy:.1f}%), K7 "
              f"{k7:.3f} ms ({100 * k7 / busy:.1f}%)")
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f"  {us / 1e3:9.4f} ms {count:4d} calls  {key[:100]}")
    else:
        print("device time: not measured (the profiler recorded no device "
              "events)")
    # K6 alone on the prefill's first call's inputs: its time against its
    # bound (the kept pairs), and every row against its plain version
    h, kv, hd, w = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                    cfg.attn_window)
    q, k, v, kw = captured[0]
    check(kw.get("causal") is True and kw.get("window") == w
          and tuple(q.shape) == (1, h, n_pre, hd)
          and tuple(k.shape) == tuple(v.shape) == (1, kv, n_pre, hd)
          and q.dtype == torch.bfloat16,
          f"the prefill's first K6 call: q {tuple(q.shape)} {q.dtype}, "
          f"k {tuple(k.shape)}, {kw}")
    k6_ms = device_ms(lambda: flash_attention(q, k, v, True, w),
                      iters=2, replays=3)
    from repro_torch.kernels.cost import flash_attention as k6_work

    k6_cost = k6_work(1, h, kv, n_pre, n_pre, hd, 2, True, w)
    b_ms, b_by = bound(k6_cost)
    print(f"K6 at (1, {h}, {n_pre}, {hd}) bf16 window {w}: "
          f"{k6_ms:.4f} ms a call, bound {b_ms:.4f} ({b_by}) = "
          f"{100 * b_ms / k6_ms:.1f}%, "
          f"{k6_cost.flops['bfloat16'] / k6_ms / 1e9:.1f} TFLOP/s")
    k6_err, plain_ms = check_long_k6(torch, dev, q, k, v, w)
    del q, k, v, captured
    free_device_memory(torch)
    # teacher-forced decode through the ring against forward (which runs
    # the same windowed K6, held above to its plain version)
    with torch.inference_mode():
        steps = [logits[0, -1]]
        for i in range(LONG_DECODE):
            tok = tokens[:, n_pre + i:n_pre + i + 1]
            lg, cache = model.decode_step(params, cache, {"tokens": tok})
            steps.append(lg[0, -1])
        del cache
        free_device_memory(torch)
        full = model.forward(params, {"tokens": tokens})
        want = full[0, n_pre - 1:n_pre + LONG_DECODE].clone()
        del full
    peak = torch.cuda.max_memory_allocated()
    for i, got in enumerate(steps):
        pos = n_pre - 1 + i
        bf16_logit_check(torch, got[None, None], want[i][None, None],
                         f"position {pos} ({'prefill' if i == 0 else f'decode {i}'}"
                         f" vs forward)", ref_name="forward")
    print(f"long prefill on {smi}: {n_pre} tokens {prefill_ms:.1f} ms, K6 "
          f"{k6_ms:.4f} ms a call, peak {peak / 1e9:.3f} GB")
    check(peak < 80e9, f"long prefill peak {peak / 1e9:.3f} GB >= 80 GB")
    del runner, model, params, steps, want
    free_device_memory(torch)
    return ({k: launches[k] for k in LM_KERNELS},
            {"shape": f"(1,{h},{n_pre},{hd}) bf16 causal window {w}",
             "ms": k6_ms, "max_abs_err": k6_err,
             "plain_ms": plain_ms,
             "plain": f"{LONG_K6_ROWS}-row slices, host clock",
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})


def driver_run(torch, train, arch: str, name: str, ck, kw: dict,
               profiled: bool = False) -> tuple:
    """One uninterrupted or resumed run of phase 21 through ``ck`` (no
    checkpoints written): (run, launches, median ms/step, ck).  Each
    step's K4-K7 launches must be ``train_launches``'s; ``profiled`` (a
    resumed run) starts the profiler once the restore is done, so the
    restore's time is not the profiler's, and prints the steps' device
    busy time a step from its kernel rows (copies left out)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profiled else None)
    ck.after_restore = prof.start if profiled else None
    run = train(arch, checkpoint_every=0, checkpoint_dir=ck.directory,
                checkpointer=ck, **kw)
    torch.cuda.synchronize()
    if profiled:
        check(run.resumed_from is not None,
              f"({name}) restored nothing: the profiler never started")
        prof.stop()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(run.history)
    want = train_launches(kw["cfg"], kw["microbatches"], True)
    check(all(launches[k] == n * v for k, v in want.items()),
          f"({name}) launches {dict(launches)} in {n} steps, a step "
          f"{want}")
    if profiled:
        rows = [r for r in device_rows(prof) if "Memcpy" not in r[0]
                and "Memset" not in r[0]]
        busy = sum(us for _, _, us in rows) / 1e3 / n
        k6 = step_rows_ms([(k, c, us / n) for k, c, us in rows], busy,
                          f"({name}) K6 and its backward", K6_ROWS)
        print(f"({name}) device busy {busy:.3f} ms a step over {n} steps "
              f"(kernel rows of the profiled run, after its restore), K6 + "
              f"bwd {k6:.3f} ms; its ms/step below are profiled")
    ms = sorted(h["seconds"] * 1e3 for h in run.history[1:])
    print(f"({name}) resumed from {run.resumed_from}, steps "
          f"{[h['step'] for h in run.history]}, losses "
          + " ".join(f"{h['loss']:.7f}" for h in run.history)
          + f"; {ms[len(ms) // 2]:.1f} ms/step (median of steps "
          f"2-{n}), {run.seconds:.1f} s in all; stragglers "
          f"{run.straggler_steps}; K4/K5 {launches['softmax_xent_fwd']}"
          f"/{launches['softmax_xent_dlogits']}; peak "
          f"{peak / 1e9:.3f} GB; checkpointer {ck.times}")
    check(launches["softmax_xent_fwd"] == 2 * n
          and launches["softmax_xent_dlogits"] == 2 * n,
          f"({name}) K4/K5 launched {launches['softmax_xent_fwd']}/"
          f"{launches['softmax_xent_dlogits']} in {n} steps")
    check(peak < 80e9, f"({name}) peak {peak / 1e9:.3f} GB")
    return run, launches, ms[len(ms) // 2], ck


def driver_phase(torch, dev, smi: str, n_params: int) -> dict:
    """Phase 21: the LM training driver (``launch.train.train``) at full
    width, DRIVER_LAYERS deep, bf16, 2 x TRAIN_SEQ tokens in 2
    microbatches: (a) a run of DRIVER_STEPS dies right after its checkpoint
    of step index 2; (b) a second run in the same directory resumes at
    step 3; (c) runs the steps uninterrupted.  Only (a) checkpoints, so the
    phase writes one checkpoint (25.3 GB for granite-3-2b at full depth)
    to the disk.  Steps 3-5 of
    (b) equal (c)'s bit for bit; where they do not, a second uninterrupted
    run (d) witnesses the step's run-to-run spread: if (c) and (d) agree
    bit for bit the step is deterministic and the resume fails, else it
    is held within max(2 x their spread, 1e-5 relative).  Returns K4's
    launches and numbers."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.train import train

    class Crash(Exception):
        pass

    class TimedCheckpointer(Checkpointer):
        """Times the snapshot (the host copy) and, waited on at once, the
        write of each save, the bytes written, and each restore, after
        which it calls ``after_restore`` if set; with ``crash`` it dies
        right after its first write, as a process would."""

        def __init__(self, directory, crash=False):
            super().__init__(directory)
            self.crash = crash
            self.times = []
            self.after_restore = None

        def save(self, step, state, blocking=True, extra_meta=None):
            t0 = time.perf_counter()
            super().save(step, state, blocking=False, extra_meta=extra_meta)
            t1 = time.perf_counter()
            self.wait()
            t2 = time.perf_counter()
            d = os.path.join(self.directory, f"step_{step}")
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            self.times.append(("save", step, (t1 - t0) * 1e3,
                               (t2 - t1) * 1e3, nbytes))
            if self.crash:
                raise Crash(step)

        def restore(self, step, like):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().restore(step, like)
            torch.cuda.synchronize()
            self.times.append(("restore", step,
                               (time.perf_counter() - t0) * 1e3))
            if self.after_restore is not None:
                self.after_restore()
            return out

    root = os.path.join(ROOT, "build", "driver_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import param_count

    def cut(arch):
        return get_config(arch).replace(n_layers=DRIVER_LAYERS)

    full = get_config(TRAIN_ARCH)
    need = (n_params * param_count(cut(TRAIN_ARCH)) / param_count(full)
            * (2 + 4 + 4))              # bf16 params, fp32 moments
    free = shutil.disk_usage(root).free
    arch = TRAIN_ARCH if free > 1.5 * need else TRAIN_HYBRID_ARCH
    cfg = cut(arch)
    print(f"checkpoint directory {root}: {free / 1e9:.1f} GB free, a "
          f"{TRAIN_ARCH} checkpoint of {cut(TRAIN_ARCH).n_layers} of its "
          f"{full.n_layers} layers needs ~{need / 1e9:.1f} GB: driving "
          f"{arch} at full width, {cfg.n_layers} layers")
    kw = dict(steps=DRIVER_STEPS, batch=2, seq=TRAIN_SEQ, microbatches=2,
              device=dev, cfg=cfg)
    runs = {}
    try:
        free_device_memory(torch)
        ck_a = TimedCheckpointer(os.path.join(root, "ck"), crash=True)
        try:
            train(arch, checkpoint_every=DRIVER_CKPT_EVERY,
                  checkpoint_dir=ck_a.directory, checkpointer=ck_a, **kw)
            check(False, "(a) did not die at its checkpoint")
        except Crash as e:
            print(f"(a) died right after the checkpoint of step {e}: "
                  f"{ck_a.times}")
        check(sorted(os.listdir(ck_a.directory)) == ["step_2"],
              f"(a) left {os.listdir(ck_a.directory)}")
        for name, sub in (("b", "ck"), ("c", "c")):
            runs[name] = driver_run(torch, train, arch, name,
                                    TimedCheckpointer(os.path.join(root, sub)),
                                    kw, profiled=name == "b")
        b, c = runs["b"][0], runs["c"][0]
        check(b.resumed_from == 2
              and [h["step"] for h in b.history] == [3, 4, 5],
              f"(b) resumed from {b.resumed_from}")
        check(c.history[-1]["loss"] < c.history[0]["loss"],
              "(c): loss did not fall")
        pairs = [(x["loss"], y["loss"])
                 for x, y in zip(b.history, c.history[3:])]
        gn = [(x["grad_norm"], y["grad_norm"])
              for x, y in zip(b.history, c.history[3:])]
        gap = max(abs(x - y) / abs(y) for x, y in pairs)
        if all(x == y for x, y in pairs + gn):
            print(f"resumed steps 3-5 bit-identical to (c) (losses and "
                  f"gradient norms): max relative gap {gap:.3e}")
        else:
            runs["d"] = driver_run(
                torch, train, arch, "d",
                TimedCheckpointer(os.path.join(root, "d")), kw)
            d = runs["d"][0]
            same_cd = all(x["loss"] == y["loss"]
                          and x["grad_norm"] == y["grad_norm"]
                          for x, y in zip(c.history, d.history))
            check(not same_cd, f"(c) and (d) are bit-identical (the step is "
                               f"deterministic) but the resume is not: max "
                               f"relative gap {gap:.3e}")
            spread = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                         for x, y in zip(c.history[3:], d.history[3:]))
            bar = max(2 * spread, DRIVER_LOSS_RTOL)
            print(f"the resume differs from (c); (c) and (d) differ too "
                  f"(relative loss spread {spread:.3e} on steps 3-5): "
                  f"resumed steps against (c) {gap:.3e} <= {bar:.3e}")
            check(gap <= bar, "the resumed losses are outside the bar")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    restores = [t for t in runs["b"][3].times if t[0] == "restore"]
    snap, write = ck_a.times[0][2], ck_a.times[0][3]
    nbytes = ck_a.times[0][4]
    print(f"{arch} driver ({cfg.n_layers} layers) on {smi}: "
          f"{runs['c'][2]:.1f} ms/step (batch 2 x "
          f"{TRAIN_SEQ}, 2 microbatches); checkpoint {nbytes} bytes "
          f"({nbytes / 1e9:.3f} GB), snapshot {snap:.1f} ms, write "
          f"{write:.1f} ms (step 2); restore {restores[0][2]:.1f} ms; "
          f"resume gap {gap:.3e}")
    return {"arch": arch, "launches": runs["b"][1]["softmax_xent_fwd"]
            + runs["c"][1]["softmax_xent_fwd"], "steps": 3 + DRIVER_STEPS,
            "ms_per_step": runs["c"][2]}


def later_path_phases(torch, dev, smi: str, n_params: int) -> dict:
    """Phases 19-21; returns the K6/K7 launches of phases 19 and 20, K6's
    numbers at phase 20's shape and phase 21's numbers."""
    phase(19, f"elastic serving: {ARCH} full width on a ring of "
              f"{ELASTIC_DEVICES} logical devices, 2 lost at decode step 4")
    elastic = elastic_serve_phase(torch, dev, smi)
    phase(20, f"{ARCH}: a {LONG_PROMPT}-token prompt past attn_window, "
              f"its last {LONG_DECODE} tokens decoded through the ring, "
              f"against forward")
    long, long_k6 = long_prefill_phase(torch, dev, smi)
    phase(21, f"the LM training driver: {TRAIN_ARCH} full width, "
              f"{DRIVER_LAYERS} layers, crash, resume and uninterrupted runs "
              f"of {DRIVER_STEPS} steps")
    driver = driver_phase(torch, dev, smi, n_params)
    return {"elastic": elastic, "long": long, "long_k6": long_k6,
            "driver": driver}


# -------------------------------------------------------------- phase 22

# the dry-run held to the card: a cell's predicted peak within
# DRY_PEAK_RTOL of what the card allocates (the FCNN cells, whose steps
# allocate a few hundred MiB, or within DRY_FCNN_SLACK)
DRY_PEAK_RTOL = 0.10
DRY_FCNN_SLACK = 64 * 2**20
DRY_FCNN_BATCH = 128
DRY_SWEEP_CELLS = 40        # dryrun --all: 10 archs x 4 shapes
# (c): the cfg part of hillclimb's variant (fused CE, one-hot embedding,
# chunked attention past 2048²) at train_4k's length, where 4096² crosses
# the threshold; the bf16 bars of PERF.md §2 at full width, fp32 order
# with the depth cut
KNOB_VARIANT = "pure_fsdp+fce+oh+chunk"
KNOB_SEQ = 4096
KNOB_FP32_LAYERS = 4
KNOB_BF16_RTOL = (2e-2, 5e-2)     # (loss, global gradient norm)
KNOB_FP32_RTOL = (1e-5, 1e-4)
PREDICT_TIMEOUT = 900
PREDICT_DIR = os.path.join(ROOT, "build", "dryrun")


class DryCell(NamedTuple):
    """A cell phase 22 runs on the meta device and on the card: an LM step
    of ``arch`` at ``shape`` (a ``ShapeSpec``) with the train step's
    ``settings``, its config ``cfg`` (None: the registered one) with
    ``overrides``, or, where ``shape`` is None, one executor step of the
    FCNN ``arch`` (NN1-NN6) at DRY_FCNN_BATCH on the RING; ``part`` is (b)
    or (c) of the module docstring's phase 22."""
    label: str
    part: str
    arch: str
    shape: object = None
    settings: object = None
    overrides: tuple = ()
    cfg: object = None


def cell_config(cell: DryCell):
    from repro_torch.configs import get_config

    return (cell.cfg or get_config(cell.arch)).replace(**dict(cell.overrides))


def dry_cells() -> list[DryCell]:
    """(b): the cells earlier phases run (phase 18's train steps and
    18g's fp32 Zamba2-1.2B step, phase 8/12/15's 2048-token prefill and
    4-slot decode step, phases 18d-18f's train steps, phase 10's executor
    step at batch 128 for NN1-NN6); (c):
    granite-3-2b at
    1 x KNOB_SEQ, baseline and KNOB_VARIANT, bf16 at full width and fp32
    cut to KNOB_FP32_LAYERS layers."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
    from repro_torch.launch.hillclimb import VARIANTS
    from repro_torch.launch.steps import TrainSettings

    serve = max(SERVE_BUCKETS)
    cells = [DryCell(f"{TRAIN_ARCH} train 2x{TRAIN_SEQ}", "b", TRAIN_ARCH,
                     ShapeSpec("train", TRAIN_SEQ, 2, "train"),
                     TrainSettings(microbatches=2)),
             DryCell(f"{TRAIN_HYBRID_ARCH} train 1x{TRAIN_SEQ}", "b",
                     TRAIN_HYBRID_ARCH,
                     ShapeSpec("train", TRAIN_SEQ, 1, "train"),
                     TrainSettings()),
             DryCell(fp32_train_label(), "b", TRAIN_HYBRID_ARCH,
                     ShapeSpec("train", TRAIN_SEQ, 1, "train"),
                     TrainSettings(),
                     (("dtype", "float32"), ("param_dtype", "float32")))]
    for arch in (ARCH, DENSE_ARCH, SSM_ARCH):
        cells += [DryCell(f"{arch} prefill 1x{serve}", "b", arch,
                          ShapeSpec("prefill", serve, 1, "prefill")),
                  DryCell(f"{arch} decode 4x{serve}", "b", arch,
                          ShapeSpec("decode", serve, 4, "decode"))]
    cells += [DryCell(family_label(ft), "b", ft.arch,
                      ShapeSpec("train", TRAIN_SEQ, ft.batch, "train"),
                      TrainSettings(microbatches=ft.microbatches),
                      (("n_layers", ft.layers),) if ft.layers else ())
              for ft in TRAIN_FAMILIES]
    cells += [DryCell(f"{nn} ORRM {RING} devices b{DRY_FCNN_BATCH}", "b", nn)
              for nn in sorted(NN_BENCHMARKS)]
    knobs = tuple(sorted(VARIANTS[KNOB_VARIANT][1].items()))
    fp32 = (("dtype", "float32"), ("n_layers", KNOB_FP32_LAYERS),
            ("param_dtype", "float32"))
    for tag, base in (("bf16", ()), (f"fp32 {KNOB_FP32_LAYERS} layers", fp32)):
        for name, over in (("baseline", base), (KNOB_VARIANT, base + knobs)):
            cells.append(DryCell(
                f"{TRAIN_ARCH} train 1x{KNOB_SEQ} {tag} {name}", "c",
                TRAIN_ARCH, ShapeSpec("train", KNOB_SEQ, 1, "train"),
                TrainSettings(), over))
    return cells


def predict_cell(cell: DryCell) -> dict:
    """The dry-run of ``cell`` on the meta device."""
    from repro_torch.launch import dryrun, dryrun_fcnn

    if cell.shape is None:
        return dryrun_fcnn.run_nn(cell.arch, DRY_FCNN_BATCH, RING)
    return dryrun.run_cell(cell.arch, cell.shape, cfg=cell_config(cell),
                           settings=cell.settings)


def predict(out_dir: str) -> int:
    """``python3 chip_smoke.py --predict DIR``: phase 22's dry-runs, on the
    meta device only (no card): ``dryrun --all`` and ``dryrun_fcnn`` into
    DIR's JSON files, then every ``dry_cells`` cell into DIR/cells.json.
    ``main`` runs it in a process of its own beside phases 2-21."""
    from repro_torch.launch import dryrun, dryrun_fcnn

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    dryrun.main(["--all", "--out", os.path.join(out_dir, "dryrun.json")])
    t1 = time.perf_counter()
    dryrun_fcnn.main(["--out", os.path.join(out_dir, "dryrun_fcnn.json")])
    t2 = time.perf_counter()
    cells = {cell.label: predict_cell(cell) for cell in dry_cells()}
    out = {"sweep_s": t1 - t0, "fcnn_s": t2 - t1,
           "cells_s": time.perf_counter() - t2, "cells": cells}
    with open(os.path.join(out_dir, "cells.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def start_predictions(out_dir: str):
    """Start ``predict`` in a child process that sees no card; its output
    goes to DIR/predict.log."""
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log = open(os.path.join(out_dir, "predict.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--predict", out_dir],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    finally:
        log.close()


def card_step(torch, dev, cell: DryCell):
    """(setup, run) of ``cell``'s step on ``dev``, as the dry-run builds it
    on meta: ``setup()`` allocates the state and inputs (seeded: the same
    weights and batch for every cell of an arch), ``run(inputs)`` is the
    step."""
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.api import get_model

    gen = torch.Generator(device=dev)
    if cell.shape is None:
        from repro_torch import exec as pexec
        from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
        from repro_torch.core.onoc_model import FCNNWorkload
        from repro_torch.launch.train_fcnn import ONOC
        from repro_torch.optim import adam

        sizes = NN_BENCHMARKS[cell.arch]
        exe = pexec.compile(FCNNWorkload(sizes, batch_size=DRY_FCNN_BATCH),
                            ONOC, RING, strategy="orrm",
                            residency="sharded", device=dev)
        opt = adam(1e-3)
        step = exe.train_step(opt)

        def setup():
            gen.manual_seed(0)
            return (exe.init_state(torch.Generator().manual_seed(0), opt),
                    {"x": torch.randn((DRY_FCNN_BATCH, sizes[0]),
                                      generator=gen, device=dev),
                     "y": torch.randint(0, sizes[-1], (DRY_FCNN_BATCH,),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)})

        return setup, lambda args: step(*args)

    cfg = cell_config(cell)
    model, shape = get_model(cfg), cell.shape

    def tokens():        # the serving cells' batches are token ids
        return {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                 generator=gen, device=dev, dtype=v.dtype)
                for k, v in model.input_specs(shape).items()}

    if shape.kind == "train":
        step = build_train_step(model, cell.settings)

        def setup():
            gen.manual_seed(0)
            return (init_train_state(model, cell.settings, gen, dev),
                    train_batch(torch, dev, cfg, shape.global_batch, gen,
                                shape.seq_len))

        return setup, lambda args: step(*args)

    def setup():
        gen.manual_seed(0)
        params = model.init(gen, dev)
        if shape.kind == "prefill":
            return params, tokens()
        return (params, model.init_cache(shape.global_batch, shape.seq_len,
                                         dev), tokens())

    def run(args):
        with torch.inference_mode():
            if shape.kind == "prefill":
                return model.prefill(*args, shape.seq_len)
            return model.decode_step(*args)

    return setup, run


def card_cell(torch, dev, cell: DryCell) -> dict:
    """One real step of ``cell`` on the card, profiled: from
    ``reset_peak_memory_stats``, with the state and inputs allocated after
    it.  Returns the peak above what was allocated before (earlier phases'
    leftovers, cuBLAS's workspace), and the step's own (the peak counter
    reset again once the state is made), the launches, the device busy ms
    and, for a train step, its loss and global gradient norm."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models.layers import use_accum_dtype

    setup, run = card_step(torch, dev, cell)
    accum = "float32" if cell.shape is None else cell_config(cell).accum_dtype
    free_device_memory(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with use_accum_dtype(accum):
        inputs = setup()
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run(inputs)
            torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - before
    launches = ops.launch_counts()
    rows = device_rows(prof)
    got = {"peak": max(setup_peak, step_peak), "step_peak": step_peak,
           "before": before, "launches": launches,
           "busy_ms": sum(us for _, _, us in rows) / 1e3 if rows else None,
           "ops": sum(c for _, c, _ in rows)}
    if cell.shape is None or cell.shape.kind == "train":
        metrics = out[1]
        got.update(loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]))
    del inputs, out
    free_device_memory(torch)
    return got


def hold_cell(cell: DryCell, pred: dict, got: dict) -> tuple[bool, str]:
    """Phase 22's three holds of a cell, and its table line: predicted
    launches = the card's, kernel by kernel; predicted peak within
    DRY_PEAK_RTOL of the card's (FCNN: or DRY_FCNN_SLACK), the cell's
    (state made from the reset) and the step's own; the roofline bound
    max(compute_s, memory_s) no more than the device busy time."""
    def within(predicted, measured):
        gap = abs(predicted - measured)
        return gap <= DRY_PEAK_RTOL * measured or (
            cell.shape is None and gap <= DRY_FCNN_SLACK)

    p_peak, m_peak = pred["peak_memory_per_device"], got["peak"]
    gap = p_peak - m_peak
    p_step, m_step = pred["step_peak_bytes"], got["step_peak"]
    peak_ok = within(p_peak, m_peak) and within(p_step, m_step)
    launches_ok = pred["kernel_launches"] == got["launches"]
    bound_ms = max(pred["compute_s"], pred["memory_s"]) * 1e3
    busy = got["busy_ms"]
    bound_ok = busy is not None and bound_ms <= busy
    launched = {k: v for k, v in got["launches"].items() if v}
    predicted = "" if launches_ok else \
        f" (predicted {pred['kernel_launches']})"
    busy_text = "not measured" if busy is None else f"{busy:.3f} ms"
    line = (f"{cell.label:48s} peak predicted {p_peak / 1e9:9.4f} GB, card "
            f"{m_peak / 1e9:9.4f} GB, gap {gap / 2**20:+10.2f} MiB "
            f"({100 * gap / max(m_peak, 1):+6.2f}%), step's "
            f"{p_step / 1e9:.4f} / {m_step / 1e9:.4f} GB "
            f"({100 * (p_step - m_step) / max(m_step, 1):+6.2f}%) "
            f"{'ok' if peak_ok else 'FAIL'} | launches "
            f"{'=' if launches_ok else '!='} {launched}{predicted} | bound "
            f"{bound_ms:.3f} ms ({pred['bottleneck']}) vs busy {busy_text} "
            f"{'ok' if bound_ok else 'FAIL'}")
    return peak_ok and launches_ok and bound_ok, line


def dryrun_phase(torch, dev, predictor, out_dir: str,
                 measured: dict) -> None:
    """Phase 22 (see the module docstring): (a) the meta sweep's results,
    each cell ``ok``, the reference's skip or refused at a kernel's limit;
    (b) and (c) every ``dry_cells`` cell's prediction held to a real step
    on the card, ``measured``'s cells (label: ``card_cell``'s numbers) to
    the steps an earlier phase took of them, the others to a step taken
    here; (c) the knob variant's loss and gradient norm held to the
    baseline's, and the two steps' peaks ordered on the card as the
    dry-run orders them."""
    from repro_torch.launch.dryrun import cell_line

    waited = wait_predictions(predictor, out_dir)
    out, sweep, fcnn = (load_predictions(out_dir, n) for n in (
        "cells.json", "dryrun.json", "dryrun_fcnn.json"))
    print(f"(a) the dry-runs ran on the meta device in a process that sees "
          f"no card, beside phases 2-21 (this phase waited {waited:.1f} s "
          f"for them): dryrun --all {out['sweep_s']:.1f} s, dryrun_fcnn "
          f"{out['fcnn_s']:.1f} s, the cells of (b) and (c) "
          f"{out['cells_s']:.1f} s")
    h = h100()
    for key, res in sweep.items():
        print(f"  {key:40s} {cell_line(res, h)}")
    ran = [r for r in sweep.values() if r.get("ok") and not r.get("skipped")]
    skipped = [r for r in sweep.values() if r.get("skipped")]
    limits = [r for r in sweep.values() if r.get("limit")]
    bad = [k for k, r in sweep.items() if not (r.get("ok") or r.get("limit"))]
    print(f"  {len(sweep)} cells: {len(ran)} ok ({sum(r['fits'] for r in ran)}"
          f" within {h.hbm_bytes / 1e9:.0f} GB), {len(skipped)} skipped as "
          f"the reference skips them, {len(limits)} refused at a kernel "
          f"wrapper's limit")
    check(len(sweep) == DRY_SWEEP_CELLS and not bad,
          f"dry-run cells neither ok, skipped nor at a kernel's limit: {bad}")
    for key, res in fcnn.items():
        print(f"  {key:32s} "
              + ("ok: degrees {degrees} (m* {onoc_cores}), ring degrees "
                 "{program_degrees}, peak {peak_memory_per_device:.0f} B, "
                 "temp {temp_gb:.4f} GB, SEND {collective_bytes:.0f} B, "
                 "compute {compute_s:.3e} s, memory {memory_s:.3e} s "
                 "({seconds} s)".format(**res) if res.get("ok")
                 else f"FAIL: {res.get('error')}"))
    check(all(r.get("ok") for r in fcnn.values()), "a dryrun_fcnn cell failed")

    got, lines = {}, []
    for cell in dry_cells():
        pred = out["cells"][cell.label]
        check(pred.get("ok"), f"{cell.label}: the dry-run ended {pred}")
        if cell.label in measured:
            got[cell.label], where = measured[cell.label], " (phase 18g's)"
        else:
            got[cell.label], where = card_cell(torch, dev, cell), ""
        ok, line = hold_cell(cell, pred, got[cell.label])
        lines.append((ok, f"({cell.part}) {line}{where}"))
        print(lines[-1][1], flush=True)

    knob_lines = []
    for tag, (loss_rtol, gnorm_rtol) in (
            ("bf16", KNOB_BF16_RTOL),
            (f"fp32 {KNOB_FP32_LAYERS} layers", KNOB_FP32_RTOL)):
        base_label = f"{TRAIN_ARCH} train 1x{KNOB_SEQ} {tag} baseline"
        var_label = f"{TRAIN_ARCH} train 1x{KNOB_SEQ} {tag} {KNOB_VARIANT}"
        base, var = got[base_label], got[var_label]
        d_loss = abs(var["loss"] - base["loss"]) / abs(base["loss"])
        d_gnorm = abs(var["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
        p_base = out["cells"][base_label]["step_peak_bytes"]
        p_var = out["cells"][var_label]["step_peak_bytes"]
        # the card orders the two steps' peaks as the dry-run does: lower
        # (higher) where the dry-run's is lower (higher) by more than
        # DRY_PEAK_RTOL, else within DRY_PEAK_RTOL of each other
        if p_var < (1 - DRY_PEAK_RTOL) * p_base:
            order_ok = var["step_peak"] < base["step_peak"]
        elif p_var > (1 + DRY_PEAK_RTOL) * p_base:
            order_ok = var["step_peak"] > base["step_peak"]
        else:
            order_ok = (p_var <= (1 + DRY_PEAK_RTOL) * p_base
                        and abs(var["step_peak"] - base["step_peak"])
                        <= DRY_PEAK_RTOL * base["step_peak"])
        ok = d_loss <= loss_rtol and d_gnorm <= gnorm_rtol and order_ok
        knob_lines.append((ok, (
            f"(c) {tag}: {KNOB_VARIANT} against the baseline from the same "
            f"weights: loss {var['loss']:.6f} vs {base['loss']:.6f} "
            f"({d_loss:.3e} <= {loss_rtol:g}), gradient norm "
            f"{var['grad_norm']:.6f} vs {base['grad_norm']:.6f} "
            f"({d_gnorm:.3e} <= {gnorm_rtol:g}); the step's peak predicted "
            f"{p_var / 1e9:.4f} vs {p_base / 1e9:.4f} GB, card "
            f"{var['step_peak'] / 1e9:.4f} vs "
            f"{base['step_peak'] / 1e9:.4f} GB "
            f"{'ok' if ok else 'FAIL'}")))
        print(knob_lines[-1][1], flush=True)
    print("\nphase 22 cells (the dry-run on meta against one step on the "
          "card):")
    for _, line in lines + knob_lines:
        print(f"  {line}")
    failed = [line for ok, line in lines + knob_lines if not ok]
    check(not failed, f"{len(failed)} phase 22 holds failed: {failed}")


# -------------------------------------------------------------- phase 23

# the dtypes of (x, w and b) in each case of phase 23; dy and y take x's
# ("c", fp32 throughout, is phases 3-6; its launches are the bar of (a)
# and (b))
BF16_CASES = {"a": ("bfloat16", "bfloat16"), "b": ("float32", "bfloat16"),
              "d": ("bfloat16", "float32")}
# the reference's ragged test shapes, an even width under 16 bytes of bf16,
# NN1's output layer at a short batch and a batch that is not a multiple
# of 64
BF16_RAGGED = ((7, 13, 5), (3, 20, 10), (32, 500, 10), (100, 64, 64))
# a bf16 output element-wise within one bf16 ulp of its plain version plus
# 1e-4 of its largest |plain| (the fp32 sums run in another order and can
# flip one rounding; a sum that cancels near 0 rounds at another scale),
# and as a whole within BF16_ULP·||plain||; fp32 outputs at GEMM_RTOL
BF16_GEMM_SLACK = 1e-4
# K3's dW where x is bf16 against the fp32 product Xᵀ·dZ rounded once to
# bf16 (the plain version): element-wise within one bf16 ulp of it plus
# ONCE_SLACK of its largest |element| (a sum within 1e-5 of the largest can
# flip one rounding, or cross 0 where the sum cancels), and bit-equal on
# all but ONCE_MISS of the elements (at most ONCE_MIN_MISS where that is
# more). dZ kept at fp32 as bf16 hi + lo leaves about 0.3% of the roundings
# flipped; dZ rounded to bf16 alone (the bf16 library product) about 40%.
ONCE_SLACK = 1e-5
ONCE_MISS = 0.01
ONCE_MIN_MISS = 4
# NN5 in bf16, kernel path against plain path from the same weights: the
# bf16 training bars of PERF.md §2 (port vs JAX reference, LM loss)
NN5_BF16_LOSS_RTOL = 2e-2
NN5_BF16_GRAD_RTOL = 5e-2
PLAIN_FNS = ("fcnn_layer_ref", "fcnn_layer_dgrad_ref", "fcnn_layer_wgrad_ref",
             "softmax_xent_fwd_ref", "softmax_xent_dlogits_ref")
# K2's contraction at or below which phase 23 expects a call on the CUDA
# cores whatever the dtypes (kernels/fcnn_layer.py's TC_NARROW, restated
# here so that a changed rule fails the phase)
BF16_NARROW = 16


def gemm_close(torch, out, want) -> tuple[bool, float, str]:
    """(ok, max abs error, the bar and the margin) of one K1-K3 output
    against its plain version: fp32 within GEMM_RTOL of the largest; bf16
    element-wise BF16_ULP·|plain| + BF16_GEMM_SLACK·max|plain| and
    norm-wise BF16_ULP."""
    check(out.dtype == want.dtype and out.shape == want.shape,
          f"output {out.dtype} {tuple(out.shape)} against the plain "
          f"version's {want.dtype} {tuple(want.shape)}")
    a, r = errors(out, want)
    if out.dtype != torch.bfloat16:
        return r <= GEMM_RTOL, a, f"fp32 rel {r:.2e}<={GEMM_RTOL:g}"
    o, w = out.double(), want.double()
    bar = (BF16_ULP * w.abs() + BF16_GEMM_SLACK * w.abs().max()).clamp_min(
        2.2250738585072014e-308)
    worst = ((o - w).abs() / bar).max().item()
    norm = ((o - w).norm() / w.norm().clamp_min(1e-300)).item()
    return (worst <= 1 and norm <= BF16_ULP, a,
            f"bf16 |d|<=2^-7|ref|+{BF16_GEMM_SLACK:g}max at {worst:.3f} of "
            f"it, ||d||/||ref|| {norm:.2e}<=2^-7")


def rounded_once(torch, out, want) -> tuple[bool, str]:
    """(ok, note) of a bf16 ``out`` held to ``want``, an fp32 result
    rounded once to bf16: within one ulp of ``want`` plus ONCE_SLACK of its
    largest element-wise, and bit-equal on all but ONCE_MISS of the
    elements (ONCE_MIN_MISS at least)."""
    check(out.dtype == want.dtype == torch.bfloat16
          and out.shape == want.shape,
          f"output {out.dtype} {tuple(out.shape)} against the rounded "
          f"product's {want.dtype} {tuple(want.shape)}")
    o, w = out.double(), want.double()
    _, exp = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), exp - 8) * (w != 0)
    bar = ulp + ONCE_SLACK * w.abs().max()
    worst = ((o - w).abs() / bar.clamp_min(2.2250738585072014e-308)).max()
    miss = int((out != want).sum().item())
    allowed = max(ONCE_MISS * want.numel(), ONCE_MIN_MISS)
    return (worst.item() <= 1 and miss <= allowed,
            f"rounded once: |d|<=ulp+{ONCE_SLACK:g}max at {worst.item():.3f} "
            f"of it, {miss} of {want.numel()} differ (<={allowed:g})")


def bf16_route(name: str, case: str, n: int) -> bool:
    """Whether a call of ``name`` in ``case`` with contraction ``n`` (K2;
    K1's and K3's output width, which does not count) must reach its
    tensor-core kernel: K1 where w is bf16; K2 where w is bf16 and n >
    BF16_NARROW; K3 where x is bf16."""
    xd, wd = BF16_CASES[case]
    if name == "fcnn_layer":
        return wd == "bfloat16"
    if name == "fcnn_layer_dgrad":
        return wd == "bfloat16" and n > BF16_NARROW
    return xd == "bfloat16"


def bf16_choices(name: str, case: str) -> list:
    """Every plan a forced call of ``name`` takes in ``case``: the
    tensor-core kernel, where it takes the case's dtypes (K1's and K2's
    where w is bf16, K3's where x is bf16), at each ("tc", width, split)
    it is built for, then the CUDA-core kernel at each plan of phase 3 (K1
    and K2: (split, slice); K3: its dW tiles)."""
    from repro_torch.kernels.fcnn_layer import (DGRAD_TC_WIDTHS,
                                                FWD_TC_WIDTHS,
                                                WGRAD_TC_WIDTHS)

    xd, wd = BF16_CASES[case]
    if name == "fcnn_layer_wgrad":
        widths, splits, tc = WGRAD_TC_WIDTHS, WGRAD_TC_SPLITS, xd
    else:
        widths = FWD_TC_WIDTHS if name == "fcnn_layer" else DGRAD_TC_WIDTHS
        splits, tc = TC_SPLITS, wd
    plans = ([("tc", w, s) for w in widths for s in splits]
             if tc == "bfloat16" else [])
    return plans + list(CHOICES[name])


def bf16_layer(torch, dev, gen, case: str, m: int, k: int, n: int,
               act: str) -> dict:
    """One layer's inputs in ``case``'s dtypes, y its plain forward, and
    each kernel's call, plain version, library calls (where timed), forced
    call at a host-plan choice (``bf16_choices``) and work
    (``kernels.cost``)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.fcnn_layer import (act_code, fcnn_layer,
                                                fcnn_layer_dgrad,
                                                fcnn_layer_wgrad)
    xd, wd = (getattr(torch, d) for d in BF16_CASES[case])
    ext = _build.extension()

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x, w = rand(m, k).to(xd), rand(k, n, scale=k ** -0.5).to(wd)
    b, dy = rand(n, scale=0.1).to(wd), rand(m, n, scale=0.01).to(xd)
    y = ref.fcnn_layer_ref(x, w, b, act)
    dz = ref.act_deriv_from_output(y.float(), act) * dy.float()
    dz_x, w_f = dz.to(xd), w.float()
    lib_act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
               "tanh": torch.tanh, "none": lambda z: z}[act]
    code = act_code(act)
    xs, ws = x.element_size(), w.element_size()

    def fwd_forced(*choice):
        out = torch.empty(m, n, device=dev, dtype=xd)
        if choice[0] == "tc":
            ext.fcnn_fwd_tc(x, w, b, out, code, *choice[1:])
        else:
            ext.fcnn_fwd(x, w, b, out, code, *choice)
        return out

    def dgrad_forced(*choice):
        dx = torch.empty(m, k, device=dev, dtype=xd)
        if choice[0] == "tc":
            ext.fcnn_dgrad_tc(dy, y, w, dx, code, *choice[1:])
        else:
            ext.fcnn_dgrad(dy, y, w, dx, code, *choice)
        return dx

    def wgrad_forced(*choice):
        dw = torch.empty(k, n, device=dev, dtype=xd)
        db = torch.empty(n, device=dev, dtype=xd)
        if choice[0] == "tc":
            ext.fcnn_wgrad_tc(x, dy, y, dw, db, code, *choice[1:])
        else:
            ext.fcnn_wgrad(x, dy, y, dw, db, code, *choice)
        return dw, db

    # the library calls: K1's bf16 addmm and act on cuBLAS in the working
    # type; K2's and K3's fp32 product of the fp32 dZ with W or x (cast to
    # fp32 once, outside the timing) and K3's column sum, the calls that
    # compute their function (TF32 off), and, second, the working type's,
    # which in (a) rounds dZ to bf16 and so computes another function
    x_f = x.float()
    return {
        "fcnn_layer": (lambda: fcnn_layer(x, w, b, act),
                       lambda: ref.fcnn_layer_ref(x, w, b, act),
                       (lambda: lib_act(torch.addmm(b.to(xd), x, w.to(xd))),),
                       fwd_forced, kcost.fcnn_fwd(m, k, n, xs, ws)),
        "fcnn_layer_dgrad": (lambda: fcnn_layer_dgrad(dy, y, w, act),
                             lambda: ref.fcnn_layer_dgrad_ref(dy, y, w, act),
                             (lambda: dz @ w_f.T, lambda: dz_x @ w.to(xd).T),
                             dgrad_forced, kcost.fcnn_dgrad(m, k, n, xs, ws)),
        "fcnn_layer_wgrad": (lambda: fcnn_layer_wgrad(x, dy, y, act),
                             lambda: ref.fcnn_layer_wgrad_ref(x, dy, y, act),
                             (lambda: (x_f.T @ dz, dz.sum(0)),
                              lambda: (x.T @ dz_x, dz_x.sum(0))),
                             wgrad_forced, kcost.fcnn_wgrad(m, k, n, xs, xs)),
    }


def bf16_outputs_close(torch, out, want) -> tuple[bool, float, str]:
    """gemm_close over the outputs of a call (a tensor or K3's pair)."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    ok, worst, notes = True, 0.0, []
    for o, w in zip(outs, wants):
        good, a, note = gemm_close(torch, o, w)
        ok, worst = ok and good, max(worst, a)
        notes.append(note)
    return ok, worst, "; ".join(notes)


def bf16_summary_key(name: str, case: str, n: int) -> str:
    """The kernel a call of ``name`` reaches in ``case`` at width or
    contraction ``n``: its tensor-core kernel ("<name>_tc") where
    ``bf16_route`` says so, else its CUDA-core one (``name``)."""
    return f"{name}_tc" if bf16_route(name, case, n) else name


def bf16_numbers(s: dict) -> dict:
    """A kernel's fields of the kernels line from its phase-23 sums
    (``run_bf16_kernels``). Where no timed call of the NN1 step reached the
    kernel, its times and bound are null: the run measured none."""
    timed = bool(s["shapes"])
    fields = {"ms": s["ms"], "plain_ms": s["plain_ms"],
              "bound_ms": s["bound_ms"],
              "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
              else "operations", "library_ms": s["library_ms"],
              "library_bf16_ms": s["library_bf16_ms"]}
    return {"max_abs_err": s["max_abs_err"],
            **{k: v if timed else None for k, v in fields.items()},
            "shapes": s["shapes"], "nn5": s["nn5"]}


def outputs_equal(torch, a, b) -> bool:
    """torch.equal over the outputs of two calls (tensors or K3's pairs)."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(p, q) for p, q in zip(a, b))


def _choice_label(name: str, choice) -> str:
    """A plan of phase 23 in its sweep line: "tc width/split", "cc
    split/slice" (K1's and K2's CUDA-core kernel), K3's "rowsxcols"."""
    if choice[0] == "tc":
        return f"tc {choice[1]}/{choice[2]}"
    if name == "fcnn_layer_wgrad":
        return "x".join(map(str, choice))
    return "cc " + "/".join(map(str, choice))


def run_bf16_kernels(torch, dev) -> tuple[dict, dict]:
    """Phase 23's kernel checks: K1-K3 in cases (a), (b) and (d) at NN1's
    layers (batch 64), NN5's (batch 128) and BF16_RAGGED, each against its
    plain version, repeated bit-identical, and each wrapper call held to
    reach the kernel ``bf16_route`` names (its ``tc_launches``); at every
    shape each plan of ``bf16_choices`` (both kernels of K1-K3 where the
    tensor-core one takes the dtypes) held to the plain version, repeated
    bit-identical and, at NN1's and NN5's layers in case (a), timed. K3's
    dW where x is bf16 is also held, at every plan, to ``rounded_once``
    against the plain version (the fp32 product rounded once), which the
    bf16 library product must miss at each timed shape.
    Returns case (a)'s sums over one NN1 step's calls by the kernel each
    reached (``bf16_summary_key``; phase 3's summary keys, and
    "library_bf16_ms": K2's and K3's product in the working type, which
    rounds dZ; "library_ms" is then the fp32 one), its NN5 rows ("nn5":
    label -> kernel, library, working-type library and bound ms) and the
    worst error of every bf16 and mixed call; and the same sums by wrapper,
    whichever kernel each call reached."""
    from repro_torch.kernels.fcnn_layer import (fcnn_layer,
                                                fcnn_layer_dgrad,
                                                fcnn_layer_wgrad)

    gen = torch.Generator(device=dev).manual_seed(23)
    wrappers = {fn.__name__: fn for fn in (fcnn_layer, fcnn_layer_dgrad,
                                           fcnn_layer_wgrad)}
    names = tuple(wrappers)
    keys = tuple(f"{name}_tc" for name in names) + names
    sums = ("ms", "plain_ms", "library_ms", "library_bf16_ms", "bound_ms",
            "bytes_ms", "ops_ms")
    summary = {key: {"max_abs_err": 0.0, **dict.fromkeys(sums, 0.0),
                     "shapes": [], "nn5": {}} for key in keys}
    steps = {name: {**dict.fromkeys(sums, 0.0), "shapes": []}
             for name in names}
    shapes = []
    for tag, sizes, batch in (("NN1", NN1, 64), ("NN5", NN5, 128)):
        last = len(sizes) - 2
        for i, (k, n) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes.append((f"{tag} L{i + 1}", batch, k, n,
                           "sigmoid" if i < last else "none", True,
                           tag))
    for m, k, n in BF16_RAGGED:
        for act in ACTS:
            shapes.append(("edge", m, k, n, act, False, None))
    for case in sorted(BF16_CASES):
        for tag, m, k, n, act, timed_shape, net in shapes:
            label = f"({case}) {tag} {m}x{k}x{n} {act}"
            calls = bf16_layer(torch, dev, gen, case, m, k, n, act)
            for name in names:
                kern, plain, libs, forced, work = calls[name]
                key = bf16_summary_key(name, case, n)
                wrapper = wrappers[name]
                before = wrapper.tc_launches
                out = kern()
                reached = wrapper.tc_launches - before
                want = plain()
                torch.cuda.synchronize()
                check(reached == int(key != name), f"{name} {label} reached "
                      f"the {'tensor' if reached else 'CUDA'}-core kernel; "
                      f"the rule names {key}")
                ok, worst, note = bf16_outputs_close(torch, out, want)
                exact = (name == "fcnn_layer_wgrad"
                         and out[0].dtype == torch.bfloat16)
                if exact:
                    held, once = rounded_once(torch, out[0], want[0])
                    ok, note = ok and held, f"{note}; dW {once}"
                same = outputs_equal(torch, out, kern())
                ok = ok and same
                s = summary[key]
                s["max_abs_err"] = max(s["max_abs_err"], worst)
                line = (f"{key:20s} {label:34s} {note} repeat "
                        f"{'bit-identical' if same else 'DIFFERS'}")
                timed = timed_shape and case == "a"
                on_step = net == "NN1" and (name != "fcnn_layer_dgrad" or
                                            not tag.endswith("L1"))
                if timed:
                    ms, plain_ms = device_ms(kern), device_ms(plain)
                    lib_ms = [device_ms(lib) for lib in libs]
                    b_ms, b_by = bound(work)
                    line += (f" | device ms: kernel {ms:.5f} plain "
                             f"{plain_ms:.5f} library {lib_ms[0]:.5f}"
                             + (f" library in bf16 (rounds dZ) "
                                f"{lib_ms[1]:.5f}" if len(libs) > 1 else "")
                             + f" bound {b_ms:.7f} ({b_by})"
                             f"{' [NN1 step]' if on_step else ''}")
                    if exact and act in ("sigmoid", "tanh"):
                        # the control: the bf16 library product, which
                        # rounds dZ to bf16, must miss the same bar (relu
                        # and none pass the bf16 dY through: dZ is bf16)
                        missed, once = rounded_once(torch, libs[-1]()[0],
                                                    want[0])
                        line += f" | bf16 library dW {once}"
                        check(not missed, f"{name} {label}: the bf16 library "
                              f"product passes the rounded-once bar ({once})")
                    if net == "NN5":
                        s["nn5"][f"{tag} {m}x{k}x{n}"] = {
                            "ms": ms, "library_ms": lib_ms[0],
                            "library_bf16_ms": lib_ms[-1], "bound_ms": b_ms,
                            "bound_by": b_by}
                    if on_step:
                        ops_s, bytes_s = work.seconds(h100())
                        got = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms[0],
                               "library_bf16_ms": lib_ms[-1],
                               "bound_ms": b_ms, "bytes_ms": bytes_s * 1e3,
                               "ops_ms": ops_s * 1e3}
                        for into in (s, steps[name]):
                            for field, v in got.items():
                                into[field] += v
                            into["shapes"].append(label)
                print(f"{line} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"{name} {label} disagrees with its plain version "
                          f"or a repeat differs")
                times = {}
                choices = bf16_choices(name, case)
                for choice in choices:
                    got = forced(*choice)
                    torch.cuda.synchronize()
                    good, err, note = bf16_outputs_close(torch, got, want)
                    if exact:
                        held, once = rounded_once(torch, got[0], want[0])
                        good, note = good and held, f"{note}; dW {once}"
                    good = good and outputs_equal(torch, got, forced(*choice))
                    check(good, f"{name} {label} at {choice}: error {err:.3e} "
                                f"({note}) or a repeat differs")
                    if timed:
                        times[_choice_label(name, choice)] = device_ms(
                            lambda c=choice: forced(*c))
                if timed:
                    best = sorted(times, key=times.get)[:3]
                    print("    sweep device ms: " + " ".join(
                        f"{c} {t:.5f}" for c, t in times.items())
                        + " | fastest " + ", ".join(
                            f"{c} {times[c]:.5f}" for c in best), flush=True)
                else:
                    print(f"    all {len(choices)} plans held to the plain "
                          f"version, repeats bit-identical", flush=True)
    for key in keys:
        s = summary[key]
        print(f"NN1 bf16 step (a), {key}: kernel {s['ms']:.5f} ms, library "
              f"{s['library_ms']:.5f} ms (in bf16 {s['library_bf16_ms']:.5f}),"
              f" plain {s['plain_ms']:.5f} ms, bound {s['bound_ms']:.7f} ms "
              f"over {len(s['shapes'])} calls")
    for name, s in steps.items():
        print(f"NN1 bf16 step (a), {name}, every call whichever kernel it "
              f"reached: kernel {s['ms']:.5f} ms, library {s['library_ms']:.5f}"
              f" ms (in bf16 {s['library_bf16_ms']:.5f}), plain "
              f"{s['plain_ms']:.5f} ms, bound {s['bound_ms']:.7f} ms over "
              f"{len(s['shapes'])} calls")
    return summary, steps


class PlainSpy:
    """Counts calls of plain versions (``kernels.ref`` functions, which the
    wrappers and ops reach through the module; by default K1-K5's) while
    active: on the card a kernel-path call must never reach one."""

    def __init__(self, names=PLAIN_FNS):
        self.calls = dict.fromkeys(names, 0)

    def __enter__(self):
        from repro_torch.kernels import ref

        self._saved = {name: getattr(ref, name) for name in self.calls}
        for name, fn in self._saved.items():
            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(ref, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        for name, fn in self._saved.items():
            setattr(ref, name, fn)


def bf16_train_parts(torch, dev, sizes, batch: int, case: str, seed: int = 0):
    """(params, Adam, its state, batches, step counter) of ``sizes`` with
    weights in the case's w dtype (``fcnn.init(dtype=)``: the fp32 draw
    rounded once) and the dataset's x in its x dtype (cast once, on the
    card); ``case`` "c" is fp32 throughout."""
    from repro_torch.launch.train_fcnn import (FULL_RUN_STEPS, LR,
                                               synthetic_batches)
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    xd, wd = (getattr(torch, d) for d in
              BF16_CASES.get(case, ("float32", "float32")))
    params = fcnn.init(sizes, torch.Generator().manual_seed(seed), dev,
                       dtype=wd)
    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    batches = synthetic_batches(sizes, 4096, batch, dev)
    batches.data["x"] = batches.data["x"].to(xd)
    return params, opt, opt.init(params), batches, torch.zeros((), device=dev)


def tc_launch_counts() -> dict[str, int]:
    """The launches of K1's, K2's and K3's tensor-core kernels
    ("<name>_tc"), which their wrappers' ``launches`` also count."""
    from repro_torch.kernels import ops

    return {f"{name}_tc": fn.tc_launches for name, fn in ops.KERNELS.items()
            if hasattr(fn, "tc_launches")}


def bf16_nn1_run(torch, dev, case: str, steps: int) -> dict:
    """``steps`` Adam steps of NN1 at batch 64 through
    ``train_fcnn.train_step`` in ``case``: host ms/step, the launches per
    step (counters reset just before, read just after; K1's and K2's
    tensor-core kernels also apart, ``tc_launch_counts``), the plain
    versions reached (none may be), the losses and the final train
    accuracy."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train_fcnn import train_step
    from repro_torch.models import fcnn

    params, opt, state, batches, step_t = bf16_train_parts(
        torch, dev, NN1, 64, case)
    torch.cuda.synchronize()
    with PlainSpy() as spy:
        ops.reset_launches()
        t0 = time.perf_counter()
        losses = [train_step(params, opt, state, next(batches), step_t)
                  for _ in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = {**ops.launch_counts(), **tc_launch_counts()}
        acc = float(fcnn.accuracy(params, batches.data["x"],
                                  batches.data["y"]))
    return {"ms": ms, "launches": launches, "plain_calls": spy.calls,
            "losses": torch.stack(losses).float().cpu().tolist(),
            "accuracy": acc, "params": params, "parts": (opt, state, batches,
                                                         step_t)}


def run_bf16_nn5(torch, dev) -> None:
    """NN5 at batch 128 in case (a), 5 steps, the kernel path against the
    plain path from the same weights: losses within NN5_BF16_LOSS_RTOL,
    step 1's gradient leaves within NN5_BF16_GRAD_RTOL of their norms."""
    from repro_torch.launch.train_fcnn import train_step
    from repro_torch.models import fcnn

    runs = {}
    for mode in (None, "ref"):
        params, opt, state, batches, step_t = bf16_train_parts(
            torch, dev, NN5, 128, "a")
        first = next(batches)
        batches.step -= 1   # step 1 trains on it
        with PlainSpy() as spy:
            grads = torch.autograd.grad(
                fcnn.loss_fn(params, first, kernel_mode=mode),
                fcnn.parameters(params))
            losses = [train_step(params, opt, state, next(batches), step_t,
                                 kernel_mode=mode).float().item()
                      for _ in range(5)]
        if mode is None:
            check(not any(spy.calls.values()), f"NN5 bf16 kernel path "
                  f"reached a plain version on the card: {spy.calls}")
        runs[mode] = (losses, grads)
    (k_loss, k_grads), (p_loss, p_grads) = runs[None], runs["ref"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    dists = [((a.float() - b.float()).norm() / b.float().norm()).item()
             for a, b in zip(k_grads, p_grads)]
    print("NN5 bf16 (a) kernel losses " + " ".join(f"{v:.6f}" for v in k_loss))
    print("NN5 bf16 (a) plain  losses " + " ".join(f"{v:.6f}" for v in p_loss))
    print(f"NN5 bf16 (a) loss rel " + " ".join(f"{v:.3e}" for v in rel)
          + f" (<= {NN5_BF16_LOSS_RTOL:g}); step 1 gradient leaves "
          + " ".join(f"{d:.3e}" for d in dists)
          + f" of their norms (<= {NN5_BF16_GRAD_RTOL:g})")
    check(max(rel) <= NN5_BF16_LOSS_RTOL, "NN5 bf16 kernel and plain losses "
          "disagree")
    check(max(dists) <= NN5_BF16_GRAD_RTOL, "NN5 bf16 kernel and plain "
          "gradients disagree")


def nn1_tc_launches(case: str) -> dict[str, int]:
    """The tensor-core launches of one NN1 step in ``case`` by
    ``bf16_route``: K1 and K3 at every layer, K2 at layers 2.. (layer 1's
    input needs no gradient)."""
    widths = NN1[1:]
    return {f"{name}_tc": sum(bf16_route(name, case, n) for n in ns)
            for name, ns in (("fcnn_layer", widths),
                             ("fcnn_layer_dgrad", widths[1:]),
                             ("fcnn_layer_wgrad", widths))}


def bf16_path_phase(torch, dev, smi: str) -> dict:
    """Phase 23 (see the module docstring); returns case (a)'s kernel sums
    by kernel and by wrapper (``run_bf16_kernels``) and its launches over
    the 300-step run."""
    from repro_torch.launch.train_fcnn import FULL_RUN_STEPS, train_step

    summary, steps = run_bf16_kernels(torch, dev)
    fp32 = bf16_nn1_run(torch, dev, "c", 5)
    tc_keys = tuple(tc_launch_counts())
    per_step = {k: v / 5 for k, v in fp32["launches"].items()}
    print(f"fp32 NN1 path (c), launches per step: {per_step}")
    check(not any(per_step.pop(k) for k in tc_keys),
          "the fp32 path reached a tensor-core kernel")
    out = {}
    for case in ("a", "b"):
        run = bf16_nn1_run(torch, dev, case, FULL_RUN_STEPS)
        got = {k: v / FULL_RUN_STEPS for k, v in run["launches"].items()}
        # the tensor-core launches a step are those the rule names
        tc = {key: got.pop(key) for key in tc_keys}
        want_tc = nn1_tc_launches(case)
        check(tc == want_tc, f"NN1 bf16 case ({case}): {tc} launches a step "
              f"on the tensor cores, the rule names {want_tc}")
        print(f"NN1 bf16 case ({case}), {FULL_RUN_STEPS} steps: loss "
              + " ".join(f"{v:.4f}" for v in run["losses"][::50])
              + f" ... {run['losses'][-1]:.4f}; final train accuracy "
              f"{run['accuracy']:.4f}; {run['ms']:.4f} ms/step host; "
              f"launches per step {got}, on the tensor cores {tc}; plain "
              f"versions reached {run['plain_calls']} on {smi}")
        check(run["accuracy"] > 0.8, f"NN1 bf16 case ({case}) failed to "
              f"learn (accuracy <= 0.8)")
        check(got == per_step, f"NN1 bf16 case ({case}) launches {got} "
              f"differ from the fp32 path's {per_step}")
        check(not any(run["plain_calls"].values()),
              f"NN1 bf16 case ({case}) reached a plain version on the card")
        params = run["params"]
        opt, state, batches, step_t = run["parts"]
        print(f"case ({case}), where a step's time goes:")
        profile_steps(torch, lambda: train_step(params, opt, state,
                                                next(batches), step_t))
        out[case] = run["launches"]
    run_bf16_nn5(torch, dev)
    return {"summary": summary, "step": steps, "launches": out["a"]}


# -------------------------------------------------------------- phase 10

RING = 8    # logical devices of the executor's ring
# the programs phase 10 holds to the single-device path: (arch, strategy,
# batch); NN1's chunk shapes are timed, the others' only checked
PROGRAM_CHECKS = (("NN1", "orrm", 64), ("NN2", "fm", 64), ("NN2", "rrm", 64),
                  ("NN2", "orrm", 64), ("NN5", "orrm", 128))
# the reference executor's bars against the single-device path
# (tests/test_exec_runtime.py): sums in another order, by column chunk
EXEC_LOSS_RTOL = 1e-6
EXEC_GRAD_RTOL, EXEC_GRAD_ATOL = 1e-4, 1e-7


def program_of(arch: str, strategy: str, batch: int):
    from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.exec import compile_fcnn_program
    from repro_torch.launch.train_fcnn import ONOC

    return compile_fcnn_program(
        FCNNWorkload(NN_BENCHMARKS[arch], batch_size=batch), ONOC, RING,
        strategy)


def chunk_label(arch: str, run) -> str:
    """The label run_kernel_phase gives the case of a RUN's chunk shape."""
    return f"{arch} P{run.layer} x{run.degree}"


def program_launches(prog) -> dict[str, int]:
    """Kernel launches one executor step makes: K1 and K3 once per window
    device and FP period, K2 at layers 2..l (layer 1's input needs no
    gradient), K4 and K5 once in the loss period."""
    degrees = [r.degree for r in prog.runs("fp")]
    return {"fcnn_layer": sum(degrees), "fcnn_layer_dgrad": sum(degrees[1:]),
            "fcnn_layer_wgrad": sum(degrees), "softmax_xent_fwd": 1,
            "softmax_xent_dlogits": 1}


def chunk_shapes(prog, arch: str, batch: int, timed: bool,
                 seen: set) -> list[tuple]:
    """kernel_cases' rows for the chunk shapes of ``prog``'s RUNs that are
    not in ``seen`` (which they join)."""
    shapes = []
    for run in prog.runs("fp"):
        key = (batch, prog.layer_sizes[run.layer - 1], run.chunk_width,
               run.activation)
        if key not in seen:
            seen.add(key)
            shapes.append((chunk_label(arch, run), *key, timed))
    return shapes


def run_chunk_kernels(torch, dev, summary) -> None:
    """K1-K3 at every chunk shape of PROGRAM_CHECKS' programs, held to
    their plain versions; NN1's timed, and summed over one executor step
    beside phase 3's single-device step."""
    shapes, seen, nn1 = [], set(), None
    for arch, strategy, batch in PROGRAM_CHECKS:
        prog = program_of(arch, strategy, batch)
        nn1 = nn1 or prog
        shapes += chunk_shapes(prog, arch, batch, arch == "NN1", seen)
    chunks = run_kernel_phase(torch, dev, shapes)
    for name in FCNN_KERNELS[:3]:
        total, calls = 0.0, 0
        for run in nn1.runs("fp"):
            if name == "fcnn_layer_dgrad" and run.layer == 1:
                continue
            k = nn1.layer_sizes[run.layer - 1]
            label = (f"{chunk_label('NN1', run)} L1 64x{k}x"
                     f"{run.chunk_width} {run.activation}")
            total += chunks[name]["rows"][label][0] * run.degree
            calls += run.degree
        print(f"NN1 ORRM executor step, {name}: kernel {total:.5f} ms over "
              f"{calls} chunk calls (single-device step, phase 3: "
              f"{summary[name]['ms']:.5f} ms over "
              f"{len(summary[name]['shapes'])} calls)")


def off_window_zero(exe, params) -> bool:
    return all(not lp[k][s].any()
               for lay, lp in zip(exe.executor._layout, params["layers"])
               for s, c in enumerate(lay.owner_chunk) if c is None
               for k in ("w", "b"))


def run_program_phase(torch, dev, summary) -> None:
    """Phase 10 (see the module docstring); ``summary`` is phase 3's."""
    from repro_torch import exec as pexec
    from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.data import Batcher, fcnn_classification_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train_fcnn import (
        FULL_RUN_STEPS,
        LR,
        ONOC,
        train_program,
    )
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine

    workload = FCNNWorkload(NN1, batch_size=64)
    exe = pexec.compile(workload, ONOC, RING, strategy="orrm",
                        residency="sharded", analyze="full", device=dev)
    prog = exe.program
    print(f"NN1 ORRM program on {RING} devices, analyzed at 'full': "
          f"{len(prog.instructions)} instructions, degrees "
          f"{list(prog.degrees)}, chunk widths "
          f"{[r.chunk_width for r in prog.runs('fp')]}, residency peak "
          f"ratio {exe.tracker.peak_ratio():.4f}")
    check(prog.degrees == (8, 4, 2), f"NN1 ORRM degrees {prog.degrees}")
    want = program_launches(prog)

    run_chunk_kernels(torch, dev, summary)

    print("train NN1 through the program, 300 steps, sharded, seed 0:")
    ops.reset_launches()
    out = train_program(arch="NN1", n_devices=RING, strategy="orrm",
                        residency="sharded", steps=FULL_RUN_STEPS, batch=64,
                        device=dev, seed=0)
    launches = ops.launch_counts()
    print(f"ms/step {out['ms_per_step']:.4f}  final train accuracy "
          f"{out['accuracy']:.4f}; launches in the run: {launches}")
    check(out["accuracy"] > 0.8, "the NN1 program failed to learn")
    for name in FCNN_KERNELS:
        check(launches[name] > 0, f"{name} was never launched by the program")
    check(off_window_zero(out["executable"], out["state"]["params"]),
          "an off-window slot is not zero after 300 steps")
    print("off-window slots after 300 steps: all exactly zero")

    opt = adam(linear_warmup_cosine(LR, 20, FULL_RUN_STEPS))
    x, y = fcnn_classification_dataset(4096, input_dim=NN1[0], seed=0)

    def stepper(e):
        state = e.init_state(torch.Generator().manual_seed(0), opt)
        step, batches = e.train_step(opt), Batcher({"x": x, "y": y}, 64, dev)
        return state, lambda: step(state, next(batches))[1]["loss"]

    _, step = stepper(exe)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    per_step = {k: v / 20 for k, v in ops.launch_counts().items()
                if k in FCNN_KERNELS}
    print("launches per executor step: " + ", ".join(
        f"{k} {v:g} (expected {want[k]})" for k, v in per_step.items()))
    check(per_step == want, "executor launches per step differ")
    host_ms, device_ops = profile_steps(torch, step)
    print(f"executor step: {device_ops:.1f} device operations/step, host "
          f"{host_ms:.4f} ms/step")
    executor = {"ms": out["ms_per_step"], "host_ms": host_ms,
                "ops": device_ops}

    # sharded against replicated, 5 Adam steps from the same weights
    e_s, e_r = (pexec.compile(workload, ONOC, RING, strategy="orrm",
                              residency=r, analyze="off", device=dev)
                for r in ("sharded", "replicated"))
    (s_s, step_s), (s_r, step_r) = stepper(e_s), stepper(e_r)
    l_s = torch.stack([step_s() for _ in range(5)])
    l_r = torch.stack([step_r() for _ in range(5)])
    same = torch.equal(l_s, l_r) and all(
        torch.equal(a, b) for a, b in zip(
            fcnn.parameters(e_s.gather_params(s_s["params"])),
            fcnn.parameters(s_r["params"])))
    print(f"5 Adam steps, sharded vs replicated: losses "
          f"{' '.join(f'{v:.7f}' for v in l_s.tolist())}; losses and "
          f"gathered parameters {'bit-identical' if same else 'DIFFER'}")
    check(same, "sharded and replicated runs differ")
    check(off_window_zero(e_s, s_s["params"]),
          "an off-window slot is not zero")

    for arch, strategy, batch in PROGRAM_CHECKS:
        sizes = NN_BENCHMARKS[arch]
        e = pexec.compile(FCNNWorkload(sizes, batch_size=batch), ONOC, RING,
                          strategy=strategy, residency="sharded", device=dev)
        params = fcnn.init(sizes, torch.Generator().manual_seed(0), dev)
        xb, yb = fcnn_classification_dataset(batch, input_dim=sizes[0],
                                             seed=3)
        b = {"x": torch.from_numpy(xb).to(dev),
             "y": torch.from_numpy(yb).to(dev)}
        loss_1 = fcnn.loss_fn(params, b)
        g_1 = torch.autograd.grad(loss_1, fcnn.parameters(params))
        sp = e.shard_params(params)
        loss_e = e.loss_fn(sp, b)
        gs = iter(torch.autograd.grad(loss_e, fcnn.parameters(sp)))
        g_e = fcnn.parameters(e.gather_params(
            {"layers": [{"w": next(gs), "b": next(gs)} for _ in sizes[1:]]}))
        d_loss = abs(loss_e.item() - loss_1.item()) / abs(loss_1.item())
        ok = d_loss <= EXEC_LOSS_RTOL and bool(torch.isfinite(loss_e))
        worst = 0.0
        for a, w in zip(g_e, g_1):
            excess = ((a - w).abs() / (EXEC_GRAD_ATOL + EXEC_GRAD_RTOL
                                       * w.abs())).max().item()
            worst = max(worst, excess)
        ok = ok and worst <= 1.0
        print(f"{arch} {strategy.upper()} batch {batch}, executor vs single "
              f"device: loss {loss_e.item():.7f} rel diff {d_loss:.3e} (<= "
              f"{EXEC_LOSS_RTOL:g}); gradients' worst |diff| / (atol + rtol"
              f"*|single|) {worst:.3f} (<= 1, rtol {EXEC_GRAD_RTOL:g}, atol "
              f"{EXEC_GRAD_ATOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch} {strategy} executor disagrees with the single "
                  f"device path")
    return executor


# -------------------------------------------------------------- phase 11


# the repeated recovery: device losses, a run each, of RECOVERY_STEPS steps
# with a checkpoint every 10, losing devices 6 and 7 at step 25
RECOVERY_REPEATS, RECOVERY_STEPS = 5, 40


def run_recovery_phase(torch, dev, executor: dict, smi: str) -> None:
    """Phase 11 (see the module docstring); ``executor`` holds phase 10's
    numbers of the same program without the runner: ms/step over the
    300-step run, and the profiled step's host ms and device operations."""
    import statistics
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.onoc_model import FCNNWorkload
    from repro_torch.launch import elastic_restart as er
    from repro_torch.models import fcnn
    from repro_torch.optim import adam, linear_warmup_cosine
    from repro_torch.runtime import (
        DegradedModeRunner,
        FaultEvent,
        FaultKind,
        FaultSchedule,
    )

    print("scenario 1, crash and restart:")
    er.crash_restart(dev)
    print("scenario 2, elastic replanning:")
    er.elastic_shrink()
    sc = er.NN1_SCENARIO
    print(f"scenario 3: NN1 {list(sc.sizes)}, batch {er.BATCH}, "
          f"{sc.n_steps} steps, seed 0, ORRM on {er.N_DEVICES} devices, "
          f"sharded, a checkpoint every {sc.checkpoint_every} steps (async)")
    out = er.device_loss_replan_resume(sc, dev)
    faulted = out["faulted"]
    report, runner = faulted["report"], faulted["runner"]
    check(len(report.replans) == 1, f"replans {report.replans}")
    rp = report.replans[0]
    check((rp["from_devices"], rp["to_devices"]) == (8, 6),
          f"replan {rp['from_devices']} -> {rp['to_devices']}")
    check(runner.program.degrees == (2, 2, 2),
          f"survivor degrees {runner.program.degrees}")
    check(report.retries == 2, f"retries {report.retries}")
    check(report.kernel_fallbacks == 0,
          f"{report.kernel_fallbacks} kernel fallbacks")
    before, after = out["segments"]
    for seg, prog in ((before, program_of("NN1", "orrm", er.BATCH)),
                      (after, runner.program)):
        want = program_launches(prog)
        print(f"launches per step on {seg['devices']} devices: " + ", ".join(
            f"{k} {v:g} (expected {want[k]})"
            for k, v in seg["launches"].items()))
        check(seg["launches"] == want,
              f"launches per step on {seg['devices']} devices differ")
        check(all(v > 0 for v in seg["launches"].values()),
              f"a kernel was not launched on {seg['devices']} devices")
    check(faulted["accuracy"] > 0.8, "the recovered run failed to learn")

    repl = er.recovery_run(sc, out["schedule"], er.N_DEVICES, "replicated",
                           dev)
    same = repl["runner"].losses == runner.losses and all(
        torch.equal(a, b) for a, b in zip(
            fcnn.parameters(repl["state"]["params"]),
            fcnn.parameters(faulted["state"]["params"])))
    print(f"replicated residency, same schedule: losses and final params "
          f"{'bit-identical' if same else 'DIFFER'} to the sharded run")
    check(same, "sharded and replicated recovery differ")
    check(repl["report"].to_dict() == report.to_dict(),
          "sharded and replicated fault reports differ")

    # K1-K3 at the survivor program's chunk shapes, which phase 10's
    # 8-device programs do not give them, held to their plain versions
    print(f"K1-K3 at the chunk shapes of the {rp['to_devices']}-device "
          f"program (degrees {list(runner.program.degrees)}):")
    run_kernel_phase(torch, dev, chunk_shapes(runner.program, "NN1",
                                              er.BATCH, True, set()))

    # the recovery's spread: more device losses of 2 of 8, a run each
    lose = FaultSchedule(events=tuple(
        FaultEvent(kind=FaultKind.DEVICE_LOSS, step=25, period=2, device=d)
        for d in (6, 7)))
    short = er.Scenario(n_steps=RECOVERY_STEPS, checkpoint_every=10)
    recovery_s = out["recovery_s"][:1]
    for _ in range(RECOVERY_REPEATS):
        again = er.recovery_run(short, lose, er.N_DEVICES, "sharded", dev)
        check(again["report"].resumed_from == [19] and
              again["report"].kernel_fallbacks == 0,
              f"repeated recovery: {again['report'].to_dict()}")
        recovery_s += er.recovery_seconds(again["clock"])
    print(f"recovery over {len(recovery_s)} device losses (the 300-step "
          f"run's first): " + " ".join(f"{v:.4f}" for v in recovery_s)
          + f" s; median {statistics.median(recovery_s):.4f}, min "
          f"{min(recovery_s):.4f}, max {max(recovery_s):.4f} (host clock "
          f"from the draw of the faulted step to that of the first "
          f"resumed step)")

    print(f"recovery on {smi}: {out['recovery_s'][0]:.4f} s from the fault "
          f"to the first resumed step (replan, validate and analyze, "
          f"rebuild, restore), median {statistics.median(recovery_s):.4f} s "
          f"over {len(recovery_s)} losses; checkpoint "
          f"{faulted['checkpoint_bytes']} bytes, save "
          f"{1e3 * faulted['snapshot_s']:.3f} ms snapshot + "
          f"{1e3 * faulted['write_s']:.3f} ms write; runner ms/step "
          f"{before['ms']:.4f} on 8 devices, {after['ms']:.4f} on 6 "
          f"(phase 10's executor step without the runner: "
          f"{executor['ms']:.4f}); final train accuracy "
          f"{faulted['accuracy']:.4f}; resumed run against the from-scratch "
          f"run: losses {out['loss_excess']:.4f}, params "
          f"{out['param_excess']:.4f} of the bars")

    # where a runner's step time goes on each ring, beside phase 10's
    # executor step: fresh runners with no faults, each run() of
    # PROFILE_STEPS steps from the same weights (its build and one
    # checkpoint save included)
    params0 = fcnn.init(list(sc.sizes), torch.Generator().manual_seed(0),
                        dev)
    opt = adam(linear_warmup_cosine(er.LR, er.WARMUP, sc.n_steps))
    batches = er.synthetic_batches(list(sc.sizes), 4096, er.BATCH, dev)
    for n in (6, 8):
        def steps(k: int, n=n) -> None:
            with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
                DegradedModeRunner(
                    workload=FCNNWorkload(list(sc.sizes), batch_size=er.BATCH),
                    base_cfg=er.ONOC, schedule=FaultSchedule(),
                    checkpointer=Checkpointer(d), optimizer=opt,
                    n_devices=n, residency="sharded",
                    checkpoint_every=sc.checkpoint_every, backoff_s=0.0,
                    device=dev).run(params0, opt.init(params0), batches, k)
            torch.cuda.synchronize()

        print(f"runner.run() on {n} devices, no faults:")
        host_ms, device_ops = profile_runs(torch, steps)
        builds = []
        for _ in range(3):   # a run() of no step: its build and set-up
            t0 = time.perf_counter()
            steps(0)
            builds.append(time.perf_counter() - t0)
        build_s = statistics.median(builds)
        print(f"runner.run() on {n} devices: {device_ops:.1f} device "
              f"operations/step, host {host_ms:.4f} ms/step, "
              f"{host_ms - 1e3 * build_s / PROFILE_STEPS:.4f} without the "
              f"build of each run() ({build_s:.4f} s, median of 3 run()s of "
              f"0 steps: replan, validate and analyze, executor, copies of "
              f"the state) (phase 10's executor step on 8: "
              f"{executor['ops']:.1f}, {executor['host_ms']:.4f} ms/step)")


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

    phase(1, "device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    predictor = start_predictions(PREDICT_DIR)
    try:
        return run_phases(torch, dev, smi, predictor)
    finally:
        if predictor.poll() is None:
            predictor.kill()
            predictor.wait()


def run_phases(torch, dev, smi: str, predictor) -> int:
    """Phases 2-23 and the last three lines; ``predictor`` is phase 22's
    dry-run process, started by ``main`` after phase 1."""
    phase(2, "build")
    from repro_torch.kernels import ops

    run_build_phase()

    phase(3, "kernels against their plain versions")
    summary = run_kernel_phase(torch, dev)
    run_floor_and_chain(torch, dev, summary)

    phase(4, "autograd through the fused ops (NN1)")
    run_autograd_phase(torch, dev)

    phase(5, "train NN1 784-1000-500-10, 300 steps, batch 64, seed 0")
    from repro_torch.launch.train_fcnn import train

    ops.reset_launches()
    out = train(arch="NN1", steps=300, batch=64, device=dev, seed=0)
    launches = ops.launch_counts()
    print(f"loss trajectory (every 25 steps): "
          + " ".join(f"{v:.4f}" for v in out["losses"][::25])
          + f" ... {out['losses'][-1]:.4f}")
    print(f"ms/step {out['ms_per_step']:.4f}  final train accuracy "
          f"{out['accuracy']:.4f}")
    print(f"launches in the training run: {launches}")
    per_step = sum(s["ms"] for s in summary.values())
    print(f"kernel time of one step at the NN1 shapes {per_step:.5f} ms "
          f"= {100 * per_step / out['ms_per_step']:.2f}% of ms/step")
    check(out["accuracy"] > 0.8, "NN1 failed to learn (accuracy <= 0.8)")
    for name in FCNN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched by the training run")

    phase("5b", "where the time of an NN1 training step goes")
    run_profile_phase(torch, dev)

    phase(6, "NN5 1024-4000-1000-4000-10, 5 steps, batch 128: kernels vs plain")
    quiet = lambda _: None  # noqa: E731
    k_run = train(arch="NN5", steps=5, batch=128, device=dev, seed=0,
                  log=quiet)
    p_run = train(arch="NN5", steps=5, batch=128, device=dev, seed=0,
                  kernel_mode="ref", log=quiet)
    diff = max(abs(a - b) for a, b in zip(k_run["losses"], p_run["losses"]))
    print("kernel losses " + " ".join(f"{v:.6f}" for v in k_run["losses"]))
    print("plain  losses " + " ".join(f"{v:.6f}" for v in p_run["losses"]))
    print(f"max |diff| {diff:.3e} (<= 1e-4)")
    check(diff <= 1e-4, "NN5 kernel and plain losses disagree")

    lm_summary, lm_launches = lm_path_phases(torch, dev)

    phase(10, "NN1 through its ORRM period program on an 8-device virtual "
              "ring")
    executor = run_program_phase(torch, dev, summary)

    phase(11, "NN1's ORRM program loses 2 of its 8 devices: replan to 6 "
              "and resume from a checkpoint")
    run_recovery_phase(torch, dev, executor, smi)

    dense_launches = dense_path_phases(torch, dev)
    family_launches = family_path_phases(torch, dev)
    train = train_path_phase(torch, dev, smi, predictor)
    families = family_train_phases(torch, dev, smi, predictor)
    later = later_path_phases(torch, dev, smi, train["n_params"])
    phase(22, "dry-runs on the meta device (dryrun --all, dryrun_fcnn, the "
              "cells earlier phases run and the knobs at 4096 tokens) held "
              "to one step of each on the card")
    dryrun_phase(torch, dev, predictor, PREDICT_DIR,
                 {fp32_train_label(): train["fp32"]["card"]})
    phase(23, "the FCNN in bf16: K1-K3 in cases (a), (b) and (d) against "
              "their plain versions, K1 and K2 on the tensor cores where w "
              "is bf16, K3 where x is bf16; NN1 300 steps in (a) and (b); "
              "NN5 kernel path against plain path")
    bf16 = bf16_path_phase(torch, dev, smi)

    kernels = []
    for name in FCNN_KERNELS:
        source, replaces = KERNEL_INFO[name]
        s = summary[name]
        extra = {}
        if name in bf16["step"]:   # K1-K3's CUDA-core kernels in bf16
            step = bf16["step"][name]
            extra["bf16"] = {
                "launches": bf16["launches"][name]
                - bf16["launches"][f"{name}_tc"],
                **bf16_numbers(bf16["summary"][name]),
                "per": "sum over the calls of one NN1 training step in "
                       "bf16, case (a), that reach this kernel (K2: the "
                       "output layer); max_abs_err over (a), (b), (d)",
                "step": {**{k: step[k] for k in ("ms", "plain_ms",
                                                 "library_ms",
                                                 "library_bf16_ms",
                                                 "bound_ms", "shapes")},
                         "per": "sum over every call of one NN1 training "
                                "step in bf16, case (a), whichever kernel "
                                "it reached"}}
        if name in XENT_KERNELS:
            ms, plain_ms, lib_ms, b_ms = s["rows"][LM_XENT_LABEL]
            extra["paths"] = {f"{TRAIN_ARCH} train": {
                "launches": train["launches"], "steps": train["steps"],
                "shape": LM_XENT_LABEL, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": "bytes"},
                f"{later['driver']['arch']} training driver": {
                "launches": later["driver"]["launches"],
                "steps": later["driver"]["steps"]}}
            for ft in TRAIN_FAMILIES:
                fam = families[ft.arch]
                shape = LM_XENT_PATHS[ft.arch]
                ms, plain_ms, lib_ms, b_ms = s["rows"][shape]
                extra["paths"][family_label(ft)] = {
                    "launches": fam["launches"][name], "steps": fam["steps"],
                    "shape": shape, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms,
                    "bound_by": "bytes"}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
            else "operations",
            "library_ms": s["library_ms"],
            "shapes": s["shapes"],
            "per": "sum over one NN1 training step",
            **extra,
        })
    for name in LM_KERNELS:
        source, replaces = KERNEL_INFO[name]
        s = lm_summary[name]
        paths = s["paths"]
        for arch, counts in ((ARCH, lm_launches), *dense_launches.items(),
                             *family_launches.items(),
                             (f"{ARCH} elastic serving", later["elastic"]),
                             (f"{ARCH} {LONG_PROMPT - LONG_TAIL}-token "
                              f"prefill",
                              later["long"])):
            if counts[name]:
                paths.setdefault(arch, {})["launches"] = counts[name]
        if name == "flash_attention":
            paths[f"{ARCH} {LONG_PROMPT - LONG_TAIL}-token prefill"].update(
                later["long_k6"])
            paths[f"{TRAIN_ARCH} train"] = {
                "launches": train["k6"]["flash_attention"],
                "steps": train["steps"]}
            for ft in TRAIN_FAMILIES:
                paths[family_label(ft)] = {
                    "launches": families[ft.arch]["launches"][name],
                    "steps": families[ft.arch]["steps"]}
        else:
            for arch, key in ((TRAIN_HYBRID_ARCH, "hybrid"),
                              (SSM_ARCH, "ssm")):
                paths[f"{arch} train"] = {
                    "launches": train[key]["launches"]["ssd_chunk"],
                    "steps": train[key]["steps"]}
        paths[fp32_train_label()] = {
            "launches": train["fp32"]["launches"][name],
            "steps": train["fp32"]["steps"]}
        extra = ({"windowed": s["windowed"]} if name == "flash_attention"
                 else {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "shapes": s["shapes"],
            "per": "call at the 2048-token prefill shape",
            "paths": paths,
            **extra,
        })
    source, replaces = KERNEL_INFO["flash_attention_bwd"]
    s = lm_summary["flash_attention_bwd"]
    for ft in TRAIN_FAMILIES:
        s["paths"][family_label(ft)] = {
            "launches": families[ft.arch]["launches"]["flash_attention_bwd"],
            "steps": families[ft.arch]["steps"]}
    s["paths"][fp32_train_label()] = {
        "launches": train["fp32"]["launches"]["flash_attention_bwd"],
        "steps": train["fp32"]["steps"]}
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": train["k6"]["flash_attention_bwd"],
        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": s["library_ms"],
        "shapes": s["shapes"],
        "per": f"call at {K6_BWD_MAIN}'s attention shape, bf16",
        "note": "no pallas_call: the counterpart of the reference's "
                "flash-style VJP _sdpa_chunked_bwd; library_ms is SDPA's "
                "backward (forward + backward less forward)",
        "paths": s["paths"],
    })
    source, replaces = KERNEL_INFO["ssd_chunk_bwd"]
    s = lm_summary["ssd_chunk_bwd"]
    for arch, key in ((TRAIN_HYBRID_ARCH, "hybrid"), (SSM_ARCH, "ssm")):
        s["paths"].setdefault(f"{arch} train bfloat16", {}).update(
            launches=train[key]["launches"]["ssd_chunk_bwd"],
            steps=train[key]["steps"])
    s["paths"].setdefault(f"{TRAIN_HYBRID_ARCH} train float32", {}).update(
        launches=train["fp32"]["launches"]["ssd_chunk_bwd"],
        steps=train["fp32"]["steps"])
    kernels.append({
        "name": "ssd_chunk_bwd", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": train["hybrid"]["launches"]["ssd_chunk_bwd"],
        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": s["library_ms"],
        "shapes": s["shapes"],
        "per": f"call at {K7_BWD_MAIN}'s SSD shape, bf16",
        "note": "no pallas_call: the counterpart of jax.vjp of the "
                "reference's jnp oracle ssd_chunk_ref; no single PyTorch "
                "call computes it (library_ms null)",
        "paths": s["paths"],
    })
    for name in ("fcnn_layer_tc", "fcnn_layer_dgrad_tc",
                 "fcnn_layer_wgrad_tc"):
        source, replaces = KERNEL_INFO[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": bf16["launches"][name],
            **bf16_numbers(bf16["summary"][name]),
            "per": "sum over the calls of one NN1 training step in bf16, "
                   "case (a), that reach this kernel",
        })
    print("\nper-kernel numbers: K1-K5 device times summed over the calls "
          "of one NN1 training step (the [NN1 step] lines of phase 3); K6/K7 "
          "per call at the shape of a 2048-token Zamba2 prefill (the "
          "[zamba2-1.2b serving path] lines of phase 7), launches from "
          "phases 5 and 8; under \"paths\", K6 and K7 at each path's "
          "prefill shape (phase 7; seamless-m4t-large-v2: its "
          "cross-attention) and their launches in that path's serving run "
          "(phases 8, 12, 14 and 15) or one prefill (phases 16 and 17); "
          "under K4/K5's \"paths\", their call at the LM loss's shape "
          "(phase 3) and their launches in phase 18's granite-3-2b steps "
          "and phase 21's driver runs (b) and (c); phases 19 and 20's "
          "launches under K6/K7's \"paths\"; K6's sliding-window cases of "
          "phase 7 under \"windowed\"; K1-K3's tensor-core kernels as "
          "fcnn_layer_tc, fcnn_layer_dgrad_tc (bf16 weights) and "
          "fcnn_layer_wgrad_tc (bf16 x), summed over the [NN1 step] lines "
          "of phase 23 in case (a) (bf16 data, bf16 network) that reach "
          "them, launches from its 300-step run, max_abs_err over the "
          "cases that reach them, library_ms the fp32 product that "
          "computes K2's and K3's function and library_bf16_ms the bf16 one "
          "that rounds dZ, \"nn5\" the NN5 layers of phase 23 in (a); "
          "under K1-K3's \"bf16\" the same for the calls that reach their "
          "CUDA-core kernels (in (a) K2's output layer) and, under "
          "\"step\", for every call of the step; flash_attention_bwd (K6's "
          "backward) per call at granite-3-2b's training attention shape "
          "in bf16 (phase 7), its launches from phase 18's granite-3-2b "
          "steps, every timed shape and dtype under \"paths\"; "
          "ssd_chunk_bwd (K7's backward) per call at Zamba2-1.2B's "
          "training SSD shape in bf16 (phase 7), its launches from phase "
          "18b's Zamba2-1.2B steps, every timed shape and dtype and phase "
          "18c's mamba2-2.7b launches under \"paths\"; K7's launches in "
          "phases 18b and 18c under its \"paths\"; phases 18d-18f's "
          "launches of K4/K5 (beside phase 3's times at their loss "
          "shapes), K6 and its backward under \"paths\" by cell, K6's "
          "backward at their attention shapes (phase 7) with its forward "
          "under \"forward\"")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(predict(sys.argv[2]) if sys.argv[1:2] == ["--predict"]
             else main())
