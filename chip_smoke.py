#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`bioreason_tpu_torch`) on one
NVIDIA H100: the quickest proof that the port builds, serves and trains on
the card.

    python3 chip_smoke.py          # needs one CUDA card

Phases, in order (any failure exits non-zero; nothing is caught and ignored):
  1. device   the card's name and power limit (nvidia-smi); TF32 off for the
              reference computations.
  2. build    compile csrc/flash_fwd.cu and csrc/flash_bwd.cu (the flash
              kernels and the banded local_* kernels, both including
              csrc/sm90.cuh) and csrc/flash_f32.cu (the fp32 kernels, flash
              and band) with nvcc for sm_90a, one nvcc each, started
              together; print each kernel's ptxas report (registers,
              spills) and, from `cuobjdump -sass`, its count of wgmma
              (HGMMA) and TMA (UTMALDG, UBLKCP, UBLKRED, ...) instructions
              and of wgmma waits (WARPGROUP.DEPBAR). Fails on a spill in
              any kernel, where flash_fwd_kernel, flash_bwd_kernel,
              local_fwd_kernel, local_bwd_kernel, flash_f32_fwd_kernel,
              flash_f32_dq_kernel or flash_f32_dkv_kernel lacks either kind
              of instruction, or where an fp32 kernel waits after every
              wgmma (ptxas serialized its products).
  3. kernels  flash_fwd against its plain version (`flash_attention_ref`,
              fp32 math) in bf16 on the card at the encoder, prefill and
              q_offset shapes and the training encoder's shape, and flash_bwd
              against `flash_attention_bwd_ref` at the SFT shapes (T=768,
              and T=1000 with left pads), the encoder shape and one causal
              q_offset shape with Tq < Tk (the forward it differentiates is
              held to `flash_attention_ref` there too), with kernel, plain,
              bound and library (torch's scaled_dot_product_attention and
              its backward, a yardstick the port never calls; is_causal
              without a mask where the case is causal, all valid and
              Tq == Tk; the lowest of three timed repetitions) times, the
              kernel (and the forward's library call) also replayed from a
              CUDA graph (event times include the host where it is slower
              than the card); then flash_fwd and flash_bwd at the long-DNA
              decoder's shape (causal, B=2, the collate's T=4480 with its
              left pads, and T=4608), and local_fwd / local_bwd against
              `local_attention_ref` / `local_attention_bwd_ref` at seven
              banded shapes (bench.py's smoke shape, the long-DNA encoder,
              T=8192, rows with no valid key, a band wider than T, a band
              edge on the 128-key tile boundary with GQA at D=128 and left
              pads, the diagonal alone), event and CUDA-graph times, with
              flash_fwd / flash_bwd at the long-DNA encoder's shape without
              the band beside them. Then the fp32 kernels (flash_f32_fwd,
              flash_f32_bwd, reached through the same wrappers on fp32
              tensors; split TF32 on the tensor cores) against the plain
              fp32 versions, TF32 off on the plain side, out and LSE within
              1e-5 and the gradients within 1e-4 of their largest magnitude
              (floored at 0.5 where the exact gradient is 0, at W = 0), two
              backward calls bitwise equal: the served prefill
              [8,896,16/8,128] causal with its left pads (forward), the
              rehearsal's SFT step [8,512,16/8,128] forward and backward, a
              batch row with no visible key, the band (b) [4,2048,16,64] at
              W=256, a causal chunk [2,136/330,16/8,128] at q_offset 194,
              the band at W=64 and W=0, flash at D=64 and the band at
              D=128, forward and backward; event, graph, plain, SDPA-on-fp32
              and bound times (three TF32 passes at 495 TFLOP/s, with the
              FFMA bound at 67 TFLOP/s beside it).
  4. serve    the port's InferenceServer at Qwen3-0.6B + NT-v2-500M width,
              bf16, weights from a fixed seed: the kernel route against the
              plain route on one request, then 8 concurrent greedy requests
              of 2 x 2048 bp, the same 8 again, and one over HTTP. Checks that
              every request is answered, greedy repeats agree, logits are
              finite and the kernel ran in every encoder and prefill layer.
  5. profile  torch.profiler over one prefill and one short engine call of
              the same batch: device time by kernel, the device's busy share.
  6. train    LoRA SFT at Qwen3-0.6B + NT-v2-500M width, bf16 frozen weights
              from seed 0: the `train_sft` CLI for 4 steps on synthetic KEGG
              items; the SFTTrainer at bench.py's shape (B=4, 768 text
              tokens, 2 x 128 DNA tokens per item, the last 128 positions
              supervised, remat off) for 2 + 10 timed steps, with flash_fwd
              and flash_bwd counted per step; one loss + gradient of the
              kernel route against the plain ('xla') route; the LoRA B leaves
              checked to have moved; one step profiled.
  7. train-long  long-DNA SFT with the encoder trained through the banded
              kernels: the `train_sft` CLI for 4 steps with --dna_attention
              local:256 --dna_model_finetune on 16 synthetic KEGG items of
              2 x 12,288 bp (encoder 4 x 2048 tokens, decoder B=2, T=4480),
              with the launches of local_fwd, local_bwd, flash_fwd and
              flash_bwd counted per step and the encoder's leaves checked to
              have moved; the same trainer for 2 + 5 timed steps; one loss +
              gradient of the kernel route against the plain route (the
              band through `local_attention_ref`, patched into this process's
              dispatch); one step profiled.
  8. grpo     GRPO at bench_grpo.py's shape (Qwen3-0.6B widths at the byte
              tokenizer's vocabulary, remat full; NT-v2-500M; 4 synthetic
              KEGG prompts of 2 x 600 bp x G = 4, 16 new tokens sampled
              (64 in bench_grpo.py; 64 before phase 11 came, 32 before
              phases 13-14 came),
              max_length_dna 128, beta 0.04, LoRA r32/a64, bf16 frozen
              weights from seed 0): the GRPOTrainer for 1 + 2 timed steps
              with phase timers, rewarded by xmlcount, correctness and the
              share of ACGT characters (which random weights vary on),
              (completions/s, seconds per phase, flash_fwd
              and flash_bwd launches per step, checked exactly, peak
              memory), one step profiled (busy share, top kernels, device
              time of the rollout, its grouped decode attention, the ref
              logps and the update), finite losses, kl and rewards, the
              LoRA B leaves moved, greedy grouped rollouts identical within
              each group, one update loss + gradient through the kernels
              against the plain route on the same rollout buffer, the
              sampler on a NaN and an all -inf row on the card, flash_fwd
              and flash_bwd against their plain versions at the step's own
              shapes and masks (the grouped prefill's P-slot prompt cache,
              the encoder, the logp passes' forward and the update's
              backward, with completions that end early as at an EOS); then
              `python -m bioreason_tpu_torch.cli.reason` for 2 steps from the
              sft_final that phase 6's train_sft CLI wrote.
  9. evo2     the committed vortex fixtures (tests/assets) through the port's
              importer on the card, fp32, held to their goldens with cuDNN's
              TF32 off and on; Evo2-1B + Qwen3-0.6B served at full width
              (bf16, weights from seed 0): the kernel vs plain route on one
              request, 8 concurrent greedy requests of 2 x 2048 bp twice
              (identical repeats), exact flash_fwd launches per engine call
              (3 tower attention blocks + 28 prefill layers), prefill latency,
              decode tokens/s, peak memory, one profiled prefill split into
              hyena convolutions / FFT, filter materialization, tower
              attention, decoder attention, GEMMs and the rest, and the
              tower's output with its filter leaves stored in bf16 (as a
              frozen SFT tower stores them) against fp32; then flash_fwd and
              flash_bwd against their plain versions at the path's own shapes
              and masks (the tower [16, 2048, 15/15, 128] causal with mixed
              left pads, the served Evo2 prefill, the finetune step's tower
              backward [4, 2048, 15/15, 128]).
 10. evo2-train  `train_sft --encoder evo2-1b` for 3 steps with the tower
              frozen and 3 with --dna_model_finetune (B=2, 16 synthetic KEGG
              items of 2 x 2048 bp in a .jsonl), exact flash_fwd / flash_bwd
              launches per step, the frozen filter leaves stored in bf16, every
              trained tower leaf moved; the finetune trainer for 1 + 3 timed
              steps (ms, memory held between steps and peak), one profiled
              step, one loss + gradient through the kernels against the plain
              route (all trainable gradients, and the tower's alone).
 11. pretrained  the port on HF-layout checkpoints at full width: a
              Qwen3-0.6B directory (config.json with the published values,
              bf16 safetensors from seed 0 with non-unit norm scales, a
              Qwen2-style byte-level tokenizer.json of 151,643 BPE tokens
              with Qwen's Split regex and the added tokens at Qwen3's ids)
              and an NT-v2-500M one (ESM config.json, vocab.txt, fp32
              safetensors with non-zero biases), written by the port's
              own writer (~3.2 GB; write and load times and GB/s);
              `load_pretrained_fusion` on the card with every imported
              leaf held bit for bit to what was written after its dtype
              cast; `train_sft --hf_llm_dir --hf_dna_dir --dataset_type
              variant_effect_coding` for 4 steps on 16 items of 2 x 2048 bp
              with --eval_every 2 --keep_top_k 1 --test_generative (exact
              flash_fwd / flash_bwd launches: per step, per eval batch, per
              test call; LoRA B moved; step ms, peak memory); `reason
              --hf_llm_dir --hf_dna_dir --sft_checkpoint <.pt>` for 2 GRPO
              steps from a reference-format file that `export_reference_sft`
              wrote from that SFT model (the first GRPO at the 151,936
              vocabulary on the card: completions/s, peak memory, finite
              loss, kl, rewards); `serve --checkpoint <sft_final>`: its
              merged prefill logits held to the unmerged SFT model's, 8
              concurrent greedy requests of 2 x 2048 bp twice, identical,
              exactly 57 flash_fwd per engine call; `train_sft
              --hf_llm_dir --evo2_dir` for 2 steps over the committed
              25-block Evo2 fixture (its head_dim of 8 takes the plain
              route; the decoder's launches counted).
 12. continuous  continuous serving at Qwen3-0.6B + NT-v2-500M width (bf16,
              weights from seed 0): (a) `tools/bench_serve.py --frozen
              bfloat16` (phase 14 runs its int8 default; 64 slots,
              96 requests here, 1.5 x capacity in place of its 3 x so the
              phase keeps its budget: 256 text + 128 DNA tokens each,
              64/32/16 new tokens sampled (half the bench's default, for the
              script's time), windows of 16, pipelined):
              decoded tokens/s, the admit / decode split, windows and mean
              occupancy, prefill calls, pool GiB, peak memory, exactly 57
              flash_fwd per prefill chunk and none in a decode window; (b)
              the batcher against GenerationEngine on phase 4's 8 requests
              (admitted 4, one window of 16, then 4; slot_len 1024): every
              decode step's logits teacher-forced on the batcher's own
              tokens (cosine >= 0.999 per row and step; the first token's
              >= 0.9999), greedy repeats identical, greedy agreement with
              the free-running engine and of a preempted, re-admitted
              request reported (not gated: bf16 near-ties), one sampled
              window with no host sync (torch's sync debug mode, against a
              control that syncs) and no attention kernel launched; (c) a
              continuous server with tiers 8x512,8x1024, decode window 8 and
              --guided_regex over HTTP: 12 sampled requests of two prompt
              lengths routed 6 and 6, every completion matching; the guided
              spec over phase 11's BPE tokenizer (151,672 ids) under the
              151,936-row head, its host time, the columns past the
              tokenizer dead, 4 sampled engine requests matching; (d)
              flash_fwd against its plain version at the admission prefill
              [64,256,16/8,128] causal, the encoder [64,128,16,64] and (c)'s
              mixed-width tier chunk with its left pads. At most 75 s.
 13. classifier  the DNA-only classifier at NT-v2-500M width (seed 0, B=16
              pairs of L=512 random 6-mer ids, 8 classes): (a)
              `tools/bench_classifier.py` as it runs alone, the encoder
              frozen (examples/s, the median of 5 repetitions of 10 steps,
              ms per step, device-busy and wall ms of one profiled step,
              peak memory), exactly 2 x 29 = 58 flash_fwd a step and no
              flash_bwd, a finite loss; (b) `--finetune_encoder`'s trainer at
              the same shape with remat off as the bench runs it (fp32
              masters and AdamW moments of 500 M parameters): 58 flash_fwd
              and 58 flash_bwd a step over 3 timed steps, the loss falling on
              one fixed batch, peak memory, then one step with remat on (116
              flash_fwd, 58 flash_bwd); (c) flash_fwd and flash_bwd against
              their plain versions at [16,512,16,64], all valid and with the
              collate's right pads; (d) `python -m
              bioreason_tpu_torch.cli.train_dna_only` for 3 steps on
              synthetic items: its test metrics, its dna_only_final rebuilt
              by `load_classifier` to the same logits. At most 60 s.
 14. int8     int8 serving at Qwen3-0.6B + NT-v2-500M width (seed 0): (a)
              the resident weight bytes of the bf16 model and of `--int8`
              (every dense of both towers, the embedding and the tied head
              int8 with per-channel scales), counted from the modules'
              storage: about half; (b) the --int8 engine against a bf16
              engine holding its dequantized weights, teacher-forced logits
              on phase 4's 8 requests (cosine >= 0.9999 per row and step:
              only the head's scale sits elsewhere); (c) --int8 and --int8
              --w8a8 against the bf16 weights: the quantization error
              (cosine floors 0.98 and 0.95, the argmax agreement); (d) the
              server with --int8 --kv_int8 --fuse --w8a8, 8 greedy requests
              twice, identical, exactly 57 flash_fwd per engine call (the
              int8 prefill attends over its fresh bf16 K/V); (e) W8A8's
              int8 x int8 -> int32 product (torch._int_mm) exact, and against
              the dequantized product at the prefill's own shapes (relative
              error, times); flash_fwd at the int8 prefill's Tk = P; (f)
              `tools/bench_serve.py` at the JAX bench's default (--frozen
              int8) and with --kv int8 --fuse --w8a8 (96 requests each,
              64/32/16 new tokens, half the bench's default):
              tokens/s, occupancy, pool and weight GiB, peak memory, 57
              flash_fwd per prefill chunk. At most 120 s.
 15. qlora    QLoRA and int8 rollouts at NT-v2-500M + Qwen3-4B width (36
              layers, hidden 2560, 32/8 heads of 128; seed 0, bf16
              compute): (a) `tools/bench_sft.py --decoder qwen3-4b --frozen
              int8` (bench.py's shape, 2 warm-up steps, 1 repetition of 4
              timed steps, cut from 3 for the script's time, one profiled
              step): examples/s, ms per step,
              device-busy ms, resident frozen and peak GiB, every dense of
              both towers int8 with bf16 scales, exactly 29 + 36 flash_fwd
              and 36 flash_bwd a step; (b) the same at --frozen bfloat16:
              int8's resident bytes as a share of bf16's, int8's peak under
              bf16's (the int8 dense's backward keeps no float weight); (c)
              one QLoRA loss and its trainable gradients against a bf16 model
              holding the dequantized weights, on the plain attention route
              (expected bitwise; held to 1e-6 relative on the loss and
              gradient cosine >= 0.999999) and through the kernels, where
              flash_bwd's dq sums in no fixed order: the int8 step run twice
              gives the noise floor, and the twin is held to the loss and a
              gradient cosine between that floor's reading and a planted
              fault's; (d) `tools/bench_grpo.py --decoder
              qwen3-4b --frozen int8 --rollout_int8` (4 prompts x G=4, 16 new
              tokens, 1 + 1 steps, cut from 1 + 2): completions/s, the phase
              timers, peak
              GiB, a finite loss and kl, exactly 3 x 29 + 4 x 36 flash_fwd
              and 36 flash_bwd a step, the reference and the rollout policy
              holding the training model's int8 weights and scales (the same
              data_ptr) and the rollout its live adapters; (e)
              `tools/bench_rollout.py` at 16 prompts x G=8 with 32 new tokens
              (1 + 1 calls, cut from 1 + 3), --frozen bfloat16 --kv bfloat16
              and --frozen
              int8 --kv int8, at Qwen3-0.6B and at Qwen3-4B: tokens/s, weight
              and peak GiB, exactly 29 + layers flash_fwd per call, and the
              grouped int8-KV decode's first-step logits against the
              ungrouped int8-KV step on the same caches, held to a cosine
              that two planted faults (the decode slot's scales dropped,
              the prompt's key and value scales swapped) fall under;
              (f) flash_fwd and flash_bwd against their plain versions at the
              4B shapes: the SFT step [4,768,32/8,128] causal, the GRPO
              prefill, encoder, logp forward and update backward. At most
              240 s.
 16. rehearsal  the quality rehearsal and the training-loop pieces that came
              with it: (a) `tools/rehearsal.py --scale bench` at its widths
              (Qwen3-0.6B + NT-v2-50M, 1-mer DNA of 32 bp), cut for time to
              96 items, 2 SFT epochs of 9 steps with a validation every 8,
              16 tokens generated in the tests and rollouts (cut from 64)
              and 1 GRPO step
              (the bench run: 1,280 items, 40 epochs at most with the probe's
              stop, every 96, 288 tokens, 80 steps): exactly 56 flash_fwd +
              28 flash_bwd per SFT step (remat full), 28 flash_fwd per eval
              batch, per probe batch and per engine call, 112 + 28 per GRPO
              step and none from the encoder, whose 32-wide heads take the
              plain path (the counts printed are those measured per call);
              the GRPO trainer's seconds by phase (rollout, update, ...);
              the val-loss, probe and reward curves in the
              metrics files, the val loss under its first reading, best-k's
              kept steps those of the JAX CLI's rule on that curve, params
              only; the artifact under the package; attention(impl=
              "pallas") at D = 32 raising; (f) flash_fwd and flash_bwd
              against their plain versions at the rehearsal's decoder shape
              (B=8, the collate's bucketed T, 16/8 heads of 128, causal, its
              pads); (c) `tools/bench_sft.py` at bench.py's shape with
              --remat off, full and dots (examples/s, peak GiB, launches per
              step, one step's device-busy and wall ms), one step's loss and
              gradients of dots against off (the
              loss equal, the gradients' cosine beside off's against
              itself); (d) an async save between two steps: the step's time
              around it, then around a blocking save at the same point, and
              the async file equal to the snapshot, not to the stepped
              parameters; (e) --debug_nans raising FloatingPointError
              at a NaN out of flash_fwd and out of an aten op. Its seconds by
              stage are printed. At most 150 s. The best checkpoint's int8 /
              W8A8 answers are not printed (phases 14-15 hold those paths to
              limits), nor is the dots step profiled a second time (bench_sft
              reports its busy and wall ms).
 17. moe      Qwen3-MoE serving at Qwen3-30B-A3B + NT-v2-500M, full width
              and depth (48 layers, hidden 2048, 32/4 heads of 128, 128
              experts of 768 with 8 active, capacity factor 1.25, untied
              head, vocab 151,936): (a) every earlier phase's memory freed
              first (fails above 2 GiB still allocated), then the model
              drawn from seed 0 in bf16 directly on the card (an fp32 stage
              would need 114 GiB): parameters, resident GiB, build seconds;
              (b) `InferenceServer` in micro-batch mode, phase 4's 8
              requests of 2 x 2 kb twice, 32 greedy tokens, equal tokens,
              exactly 29 + 48 = 77 flash_fwd per engine call, all of them
              in its prefill (one prefill alone counts 77): prefill ms,
              decode tokens/s; (c) the served prefill's drops per layer (the
              tokens that lose a choice, the left pads among them), every
              layer's slots and keep flags held equal to the JAX form's (a
              cumsum over the [N, E] one-hot), the experts' loads and the
              mean cosine between the router's input rows, one
              request's prefill logits through the kernels against the
              plain route, one MoE layer in bf16 against the port's fp32
              `moe_apply` on the served prefill's own input (the share of
              tokens routed alike, their cosine) and the largest tensor that
              bf16 call allocates against N * E * C; (d) the grouped decode,
              2 prompts x G = 4, greedy, twice: a prompt's completions equal,
              the runs equal; (e) `tools/bench_serve.drive` on this
              model at 16 slots, 32 requests of 256 text + 128 DNA tokens,
              32/16/8 new tokens (cut from 64/32/16):
              tokens/s, pool GiB, 77 flash_fwd per prefill chunk and none in
              a window, the rows that lost a choice in each decode window;
              (g) one prefill and one decode step profiled, device ms by
              part (router and top-k, slots, dispatch gather, expert bmm,
              combine, attention, the rest), busy share, launches; the
              expert products' bound (FLOPs / 989e12 against bytes /
              3.35e12) as the capacity form computes them and as this run's
              data needs them; (f) the bf16 teacher-forced logits, then
              `serving_storage(int8=True)` in place (both copies would need
              86 GiB): resident GiB, the cosine against bf16 held to
              phase 14's floor, under which a planted fault (one scale per
              bank) must fall, one engine call's tokens/s, the int8
              profile; (h)
              flash_fwd at [8,896,32/4,128] causal with the served left pads
              against its plain version (GQA ratio 8). At most 180 s.

 18. moe_train  MoE training at Qwen3-30B-A3B + NT-v2-500M, full width and
              depth: (a) every earlier phase's memory freed first (fails
              above 2 GiB), the model drawn in bf16 on the card, LoRA
              r32/a64 (the LoRAConfig defaults) on q, k, v, o and the router
              of all 48 layers (240 adapted linears), no frozen leaf up-cast;
              (b) 3 SFTTrainer steps at bench.py's shape on one repeated
              batch, remat on: ms a step, examples/s, peak GiB, the losses
              (finite, falling), exactly 29 + 2 x 48 flash_fwd and 48
              flash_bwd a step, and every layer's forward and recompute
              routed alike (experts and keep flags); (c) one step's loss and
              trainable gradients through the kernels against the plain
              route, then flash_fwd / flash_bwd alone at [4,768,32/4,128]
              causal (GQA 8) against their plain versions, SDPA's backward
              the lowest of 3 runs; (d) 1 GRPOTrainer step (cut from 2) at
              bench_grpo.py's shape (4 prompts x G=4, P=332, 32 new
              tokens, half of bench_grpo.py's 64, beta 0.04, no int8
              rollout, no sync): completions/s,
              seconds by phase, peak GiB, 48 + 3 x 29 + 3 x 48 flash_fwd and
              48 flash_bwd a step, the reference and the rollout policy
              holding the model's banks (data_ptr); (e) QLoRA in place:
              fresh adapters from (b)'s seed, the projection as (b) began,
              resident GiB, the same 3 SFT steps (the first loss against
              (b)'s), 1 GRPO step with int8 rollouts sharing the banks; then
              on a 2-layer model at full width one QLoRA step against its
              dequantized bf16 twin (phase 15's check) and, remat off, the
              bytes of float banks autograd saves and the peak, the int8
              bank product against torch.bmm on the dequantized bank.
 19. fp32_api the fp32 route and the user API at Qwen3-0.6B + NT-v2-50M:
              `train_sft --dtype float32` for 2 steps (the route that raised
              before the fp32 kernels; 56 flash_f32_fwd and 28 flash_f32_bwd
              a step), 3 SFTTrainer steps in fp32 through the kernels and on
              the plain route (losses within 1e-4 relative),
              `DnaLLM.generate_text` on 8 KEGG prompts over that fp32 model
              (28 flash_f32_fwd) and `make_traces --backend engine` on 4
              variant rows (its int8 bf16 storage: 28 flash_fwd).
 20-23. multi-device on the one card (parallel/): (21-22) two processes
              sharing the card over gloo: a probe of which collectives gloo
              takes on CUDA tensors (each in its own pair of processes),
              long-DNA SFT on sp_local:256 (loss and encoder gradients
              against local:256), NT-v2-500M on sp_pallas and Evo2-1B on
              sp (against one device), Qwen3-0.6B as two GPipe stages of
              14 layers at M=4 (loss and LoRA gradients against the plain
              decoder), each rank's launches counted; the kernels at those
              per-rank shapes; (20) a world of one NCCL rank: its
              collectives and SFTTrainer(mesh=) beside the one-device
              trainer at bench.py's shape; (23) the rigged-reward GRPO
              check through flash_fwd / flash_bwd (late > 1.5x early).
 24. tp       generation, GRPO and the classifier under the mesh's 'model'
              axis: two processes on the card over gloo in a mesh (1, 1, 2),
              the decoder's layers split over them (8/4 heads of 128 a rank)
              and the NT-v2-500M encoder's (8 heads of 64 and 2048 MLP rows
              a rank), phase 8's configuration from seed 0, rank 0 holding
              the one-device model beside: (a) 8 prompts, greedy, 8 new
              tokens (cut from 32): the first tokens equal one device's,
              every (row, step) logit row teacher-forced on one device's
              stream at cosine >= CONT_STEP_COS, each rank's caches exactly
              half one device's bytes, 29 + 28 flash_fwd per engine call,
              the encoder's at 8 heads and the decoder's at 8/4; (b) the
              same on the grouped rollout (4 prompts x G = 4, 16 new
              tokens); (c) GRPOTrainer(mesh=) for 1 timed step (cut from
              a warm-up + 2; its schedule without warm-up, so that the one
              step moves the adapters; the engine warm from (a) and (b)):
              the ranks' sampled rollouts equal, finite losses,
              kl and rewards, the LoRA B leaves moved, flash_fwd and
              flash_bwd launched exactly as phase 8 counts on each rank at
              its heads (the encoder's 3 x 29 a step at 8), step ms per rank
              against one device, one update on the last rollout buffer
              against one device (loss within MESH_LOSS_RTOL, LoRA
              gradients cosine >= SP_COS); (e) ClassifierTrainer(mesh=) at
              NT-v2-500M, bf16, the encoder trained, remat off, on phase
              13's [16, 512] batch for TP_CLS_STEPS steps: each step's loss
              within MESH_LOSS_RTOL of the one-device trainer's on the same
              parameters, the first step's encoder gradients cosine >=
              SP_COS, each step's launches equal to one device's (58
              flash_fwd, 58 flash_bwd) with every one at [16, 512, 8, 64];
              (f) QLoRA at phase 8's GRPO configuration on the same mesh
              (frozen_dtype="int8", rollout_int8, rollout_kv_int8; the int8
              weights and scales whole on both ranks, as JAX places them):
              the int8 rollout copy's grouped greedy call (8 new tokens)
              teacher-forced on one device's int8 rollout stream as in (b),
              each rank's KV
              cache half one device's bytes, each rank's int8 bytes (the
              training model's and the rollout copy's) one device's, then
              one step as in (c) with its gates (ranks' completions equal,
              launches and heads, LoRA B moved, the update against one
              device's QLoRA update) and its ms against one device's; (g)
              SFTTrainer(frozen_dtype="int8") at bench.py's shape on a
              second mesh of the two processes, (1, 2, 1) (fsdp: 2 rows a
              rank, the adapters sharded, the int8 weights whole), for
              TP_SFT_STEPS steps: loss and grad-norm within MESH_LOSS_RTOL
              of the one-device QLoRA trainer's, launches a step equal, int8
              bytes equal, resident and peak GiB a rank; (h) bf16 LoRA
              SFTTrainer at bench.py's shape on the mesh (1, 1, 2) with
              Qwen3-0.6B's 151,936-row table (tied head) and the DNA
              projection split over 'model': each rank's table [75968,
              1024] and projection [512, 1024] (not replicated), their GiB,
              resident and peak GiB against one device; TP_SFT_STEPS steps
              whose loss and grad norm are held to one device's within
              H_LOSS_RTOL / H_NORM_RTOL, with 57 flash_fwd + 28 flash_bwd
              a step a rank at [4,768,8/4,128] (the encoder's at 8 heads);
              the first step's gradients (cosine >= H_GRAD_COS) and one
              `per_token_logps` pass (within H_LOGP_ATOL) against one
              device's; each gate checked to lie between the noise floor
              (one device's step taken twice) and a planted fault of the
              split CE (`_vocab_faults`); one greedy engine call of 8
              prompts and 8 new tokens on the split head, teacher-forced on
              one device at cosine >= CONT_STEP_COS, its caches half one
              device's bytes; (d) flash_fwd / flash_bwd at a rank's grouped
              prefill [4,P,8/4,128], at the classifier's [16,512,8,64] and
              at (g)'s and (h)'s per-rank shapes against their plain
              versions. A hang guard of TP_HANG_S.

Before its last line it prints one JSON object {"kernels": [...]}; its last
line is {"ok": true, "device": {...}}. It exits non-zero without a result
where torch.cuda.is_available() is false or the port's package is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain: the kernel rounds P to bf16 before the P @ V product (as
# the Pallas kernel does) and writes bf16, the plain version keeps fp32 and
# rounds once at the end; |out| <~ 4 here, where one bf16 ulp is 2^-6
OUT_ATOL, OUT_RTOL = 2e-2, 2e-2
# the LSE is fp32 in both: same bf16 products, other summation order, __expf
LSE_ATOL = 1e-3

# flash_bwd vs its plain version: the kernel rounds P and dS to bf16 before
# their products (as the Pallas kernels do) and writes bf16 gradients; the
# plain version keeps fp32 throughout. Each gradient element is a sum of up
# to ~1000 such terms whose rounding errors (2^-9 relative) mostly cancel, so
# the error stays well under 2% of the gradient's largest element
BWD_RTOL_OF_MAX = 2e-2
# ... of the larger of max |ref| and this floor: at W = 0 every query sees
# only itself, P = 1 and dS = P * (dP - delta) cancels, so the exact dq and dk
# are 0 and both versions give fp32 rounding noise (~1e-6) of the dP and
# delta they subtract; every other case's max |ref| is above 1 and unchanged
BWD_SCALE_FLOOR = 1e-2

# the fp32 kernels (csrc/flash_f32.cu) against their plain fp32 versions on
# the card, TF32 off on both sides: both keep every product in fp32 (FFMA
# against cuBLAS's fp32 GEMM) and differ in summation order and the online
# softmax's rescaling, ~1e-7 relative per sum; out and the LSE are held to
# 1e-5 of their largest magnitude, the gradients (sums over every query or
# key of a tile walk) to 1e-4 of theirs
F32_OUT_RTOL_OF_MAX, F32_LSE_RTOL_OF_MAX, F32_BWD_RTOL_OF_MAX = 1e-5, 1e-5, 1e-4
# ... of the larger of max |ref| and this floor: at W = 0 the exact dq and dk
# are 0 (P = 1, dS = P * (dP - delta) cancels) and both versions give fp32
# rounding noise (~1e-5); every other fp32 case's gradients have max |ref|
# above 0.8, where the floor does not bind
F32_BWD_SCALE_FLOOR = 0.5
# H100 SXM TF32 on the tensor cores and fp32 outside them (NVIDIA data
# sheet), for the fp32 kernels' bounds: split TF32 runs three TF32 passes
# per product, so their bound is 3 * FLOPs / PEAK_TF32_FLOPS; the FFMA bound
# (FLOPs / PEAK_FP32_FLOPS) of the CUDA-core design they replaced is printed
# beside it as a yardstick
PEAK_TF32_FLOPS, TF32_PASSES = 495e12, 3
PEAK_FP32_FLOPS = 67e12

# the redesigned kernels (wgmma + TMA) and the SASS opcodes counted as TMA
REDESIGNED = ("flash_fwd_kernel", "flash_bwd_kernel", "local_fwd_kernel", "local_bwd_kernel",
              "flash_f32_fwd_kernel", "flash_f32_dq_kernel", "flash_f32_dkv_kernel")
TMA_OPS = ("UTMALDG", "UTMASTG", "UTMAREDG", "UTMAPF", "UBLKCP", "UBLKRED")

ENCODER_LAYERS, DECODER_LAYERS = 29, 28
LONG_DNA_BP, LONG_WINDOW = 12288, 256     # 2048 encoder tokens per sequence


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def smi_clocks() -> str:
    """The card's SM clock, power draw and temperature, for the record."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


# -- phase 2 -----------------------------------------------------------------

def ptxas_report(log_text: str) -> dict:
    """function -> {"registers", "spill_stores", "spill_loads", "smem"} from
    nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return out


def sass_counts(path) -> dict:
    """function -> {"HGMMA": n, "TMA": n, "DEPBAR": n} from `cuobjdump -sass` of a
    library (DEPBAR: wgmma waits, one per HGMMA where ptxas serialized them)."""
    from bioreason_tpu_torch.ops.cuda_build import cuda_tool
    res = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {path} failed: {res.stderr.strip()[-500:]}")
    out, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"HGMMA": 0, "TMA": 0, "DEPBAR": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn is not None:
            op = m.group(1)
            if op == "HGMMA":
                out[fn]["HGMMA"] += 1
            elif op in TMA_OPS:
                out[fn]["TMA"] += 1
            elif op == "WARPGROUP":
                out[fn]["DEPBAR"] += "WARPGROUP.DEPBAR" in line
    return out


def phase_build():
    """Both kernels, one nvcc per source, started together; their ptxas
    reports and SASS instruction counts. Returns kernel -> numbers."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops.cuda_build import library_path
    t0 = time.perf_counter()
    reports = fa.build(*fa.LIBRARIES)
    log(f"build: {', '.join(reports)} in {time.perf_counter() - t0:.2f} s")
    kernels = {}
    for name, report in reports.items():
        ptx = ptxas_report(report)
        sass = sass_counts(library_path(name))
        log(f"build: {name} ({library_path(name).name})")
        for fn in sorted(set(ptx) | set(sass)):
            row = {**ptx.get(fn, {}), **sass.get(fn, {})}
            kernels[fn] = row
            log(f"  {fn[:96]}: {row}")
            if row.get("spill_stores") or row.get("spill_loads"):
                fail(f"ptxas spills in {fn}: {row}")
    if not all(reports.values()):
        log("build: a library was already built in this checkout: no ptxas report for it")
    for want in REDESIGNED:
        mine = {fn: row for fn, row in kernels.items() if want in fn}
        if not mine or any(not row.get("HGMMA") or not row.get("TMA") for row in mine.values()):
            fail(f"{want}: every build needs HGMMA and TMA instructions, got {mine}")
        # the fp32 kernels issue their products in batches: a wait after every
        # wgmma means ptxas serialized them (its C7515 note)
        if "f32" in want and any(row["DEPBAR"] >= row["HGMMA"] for row in mine.values()):
            fail(f"{want}: ptxas serialized the wgmma products, got {mine}")
    return kernels


# -- phase 3 -----------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_min_ms(fn, iters: int = 10) -> float:
    """A library yardstick's time: the lowest of three repetitions of
    `cuda_ms`, so that its noise counts against the kernel, not for it."""
    return min(cuda_ms(fn, iters=iters) for _ in range(3))


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so no host time between launches enters (`cuda_ms` includes
    it where the host is slower than the card, as at the small shapes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # capture wants a warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_case(torch, name, b, tq, tk, hq, hkv, d, causal, q_offset, mask, seed):
    """Kernel against plain on one shape; returns the row of numbers."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import flash_attention as fa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, tq, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    qo = q_offset if q_offset is not None else (tk - tq if causal else 0)

    out, lse = fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset,
                                  return_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, mask, causal, qo)
    vis = mask.bool()[:, None, :].expand(b, tq, tk)
    if causal:
        vis = vis & (torch.arange(tk, device=dev)[None, :]
                     <= torch.arange(tq, device=dev)[:, None] + qo)
    rows = vis.any(-1)                                             # [B, Tq]
    o, r = out.float()[rows], ref_out.float()[rows]
    err = float((o - r).abs().max())
    if not torch.allclose(o, r, atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: out differs from the plain version, max abs err {err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, tq)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: lse differs from the plain version by {lse_err:.4g}")
    empty = ~rows
    if bool(empty.any()):
        if bool(out[empty].ne(0).any()) or bool(lse.transpose(1, 2)[empty].ne(fa.NEG_INF).any()):
            fail(f"kernel {name}: fully masked rows are not (0, -1e30)")

    def kernel():
        return fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
    ms = cuda_ms(kernel, iters=20)
    dev_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, mask, causal, qo), iters=3,
                       warmup=1)
    # library yardstick: one SDPA call on the same work (layout copies and
    # the boolean mask are made before timing)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if causal and tq == tk and qo == 0 and bool(mask.bool().all()):
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=hkv != hq)
    else:
        amask = vis[:, None]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                  enable_gqa=hkv != hq)
    library_ms = library_min_ms(library)
    library_dev_ms = graph_ms(library)

    # the work this data needs: (query, key) pairs with a visible key; QK^T
    # and PV take 2 flops per multiply-add each
    flops = 4.0 * d * hq * float(vis.sum())
    # the bytes it needs: q rows that see a key, k/v rows that some query
    # sees (keys past the causal reach or padded out need not be read), all
    # of out and lse, and the mask
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    nbytes = (2 * (q_rows * hq * d + 2 * kv_rows * hkv * d + out.numel())
              + 4 * lse.numel() + 4 * mask.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    row = {"shape": name, "B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
           "causal": causal, "q_offset": qo, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_graph_ms": library_dev_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name}: B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} causal={causal} "
        f"q_offset={qo}: max_abs_err {err:.3g} (lse {lse_err:.3g}); ms {ms:.4f} (graph "
        f"{dev_ms:.4f}) plain_ms {plain_ms:.3f} library_ms {library_ms:.4f} (graph "
        f"{library_dev_ms:.4f}) bound_ms {row['bound_ms']:.4f} "
        f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s")
    return row


def bwd_case(torch, name, b, tq, tk, hq, hkv, d, causal, q_offset, mask, seed):
    """flash_bwd against flash_attention_bwd_ref on one shape: the same bf16
    q, k, v, dO, and the kernel forward's out and lse, on the card. That
    forward is first held to flash_attention_ref, so an error of flash_fwd
    at this shape cannot hide in the backward's inputs."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import flash_attention as fa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                                   (b, tq, hq, d)))
    out, lse = fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset,
                                  return_lse=True)
    grads = fa.flash_bwd(q, k, v, mask, causal, q_offset, out, lse, dout)
    torch.cuda.synchronize()
    vis = mask.bool()[:, None, :].expand(b, tq, tk)
    if causal:
        vis = vis & (torch.arange(tk, device=dev)[None, :]
                     <= torch.arange(tq, device=dev)[:, None] + q_offset)
    rows = vis.any(-1)                                             # [B, Tq]
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, mask, causal, q_offset)
    o, r = out.float()[rows], ref_out.float()[rows]
    fwd_err = float((o - r).abs().max())
    if not torch.allclose(o, r, atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: the forward's out differs from the plain version, "
             f"max abs err {fwd_err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, tq)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: the forward's lse differs from the plain version by {lse_err:.4g}")
    del ref_out, ref_lse, o, r
    refs = fa.flash_attention_bwd_ref(q, k, v, mask, causal, q_offset, out, lse, dout)
    errs = {}
    for gname, got, ref, sel in (("dq", grads[0], refs[0], rows), ("dk", grads[1], refs[1], None),
                                 ("dv", grads[2], refs[2], None)):
        a, r = got.float(), ref.float()
        if sel is not None:
            a, r = a[sel], r[sel]
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name}: {gname} is not finite")
        errs[gname] = float((a - r).abs().max())
        ref_max = float(r.abs().max())
        if errs[gname] > BWD_RTOL_OF_MAX * ref_max:
            fail(f"kernel {name}: {gname} differs from the plain version by {errs[gname]:.4g} "
                 f"(max |ref| {ref_max:.4g}, tolerance {BWD_RTOL_OF_MAX} of it)")
        errs[gname + "_ref_max"] = ref_max
    empty = ~rows
    if bool(empty.any()) and bool(grads[0][empty].ne(0).any()):
        fail(f"kernel {name}: fully masked rows have dq != 0")

    def kernel():
        return fa.flash_bwd(q, k, v, mask, causal, q_offset, out, lse, dout)
    ms = cuda_ms(kernel, iters=20)
    dev_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, mask, causal, q_offset, out,
                                                          lse, dout), iters=3, warmup=1)
    # library yardstick: the backward of one SDPA call on the same work, on
    # a retained graph (layout copies and the mask made before timing)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    if causal and tq == tk and bool(mask.bool().all()):
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hkv != hq)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis[:, None],
                                           enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    def library():
        return torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)
    library_ms = library_min_ms(library)

    # the work this data needs: 10*D flops per visible (query, key) pair and
    # head (Q K^T, dO V^T, P^T dO, dS K, dS^T Q); q, out, dO and lse read for
    # the query rows that see a key, k and v for the keys some query sees,
    # the mask read once; all of dq, dk, dv written once
    flops = 10.0 * d * hq * float(vis.sum())
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    nbytes = (2 * (3 * q_rows * hq * d + 2 * kv_rows * hkv * d)   # q out dO, k v
              + 4 * q_rows * hq + 4 * mask.numel()                # lse, mask
              + 2 * (q.numel() + 2 * k.numel()))                  # dq, dk dv
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    err = max(errs["dq"], errs["dk"], errs["dv"])
    row = {"shape": name, "B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
           "causal": causal, "q_offset": q_offset, "fwd_max_abs_err": fwd_err,
           "fwd_lse_max_abs_err": lse_err, "max_abs_err": err, **errs, "ms": ms,
           "graph_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name} (bwd): B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} causal={causal} "
        f"q_offset={q_offset}: forward max abs err {fwd_err:.3g} (lse {lse_err:.3g}); max abs err "
        f"dq {errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g} (max |ref| "
        f"{errs['dq_ref_max']:.3g} {errs['dk_ref_max']:.3g} {errs['dv_ref_max']:.3g}, tolerance "
        f"{BWD_RTOL_OF_MAX} of each); ms {ms:.4f} (graph {dev_ms:.4f}) plain_ms "
        f"{plain_ms:.3f} library_ms {library_ms:.4f} bound_ms "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def right_padded(torch, b, t, lo, gen):
    lens = torch.randint(lo, t + 1, (b,), generator=gen, device="cuda")
    return (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)


def left_padded(torch, b, p, extra, max_pad, gen):
    """Prompt mask [B, p + extra]: left pads, `extra` empty decode slots."""
    pads = torch.randint(0, max_pad + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(p + extra, device="cuda")[None, :]
    return ((pos >= pads[:, None]) & (pos < p)).to(torch.int32)


def band_visible(torch, t, window, mask):
    """[B, T, T] bool: key j visible to query i, |i - j| <= window and mask[j]."""
    i = torch.arange(t, device="cuda")
    return ((i[:, None] - i[None, :]).abs() <= window)[None] & mask.bool()[:, None, :]


def local_case(torch, name, b, t, hq, hkv, d, window, mask, seed):
    """local_fwd and local_bwd against their plain versions on one shape, in
    bf16: out on every row (pad queries are computed, as on the TPU), the
    LSE on rows that see a key, rows that see none exactly (0, -1e30) with
    dq = 0; dq, dk, dv within BWD_RTOL_OF_MAX of the largest |ref|. Returns
    the forward's and the backward's rows of numbers."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import local_attention as la
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                                   (b, t, hq, d)))
    out, lse = la.local_attention(q, k, v, window, mask, return_lse=True)
    grads = la.local_bwd(q, k, v, window, mask, out, lse, dout)
    torch.cuda.synchronize()
    vis = band_visible(torch, t, window, mask)
    rows = vis.any(-1)                                             # [B, T]
    ref_out, ref_lse = la.local_attention_ref(q, k, v, window, mask)
    err = float((out.float() - ref_out.float()).abs().max())
    if not torch.allclose(out.float(), ref_out.float(), atol=OUT_ATOL, rtol=OUT_RTOL):
        fail(f"kernel {name}: local_fwd out differs from the plain version, max abs err {err:.4g}")
    lrows = rows[:, None, :].expand(b, hq, t)
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if lse_err > LSE_ATOL:
        fail(f"kernel {name}: local_fwd lse differs from the plain version by {lse_err:.4g}")
    empty = ~rows
    n_empty = int(empty.sum())
    if n_empty and (bool(out[empty].ne(0).any())
                    or bool(lse.transpose(1, 2)[empty].ne(la.NEG_INF).any())
                    or bool(grads[0][empty].ne(0).any())):
        fail(f"kernel {name}: rows with no visible key are not (0, -1e30) with dq = 0")
    del ref_out, ref_lse
    refs = la.local_attention_bwd_ref(q, k, v, window, mask, out, lse, dout)
    errs = {}
    for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        a, r = got.float(), ref.float()
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name}: local_bwd {gname} is not finite")
        errs[gname] = float((a - r).abs().max())
        ref_max = float(r.abs().max())
        if errs[gname] > BWD_RTOL_OF_MAX * max(ref_max, BWD_SCALE_FLOOR):
            fail(f"kernel {name}: local_bwd {gname} differs from the plain version by "
                 f"{errs[gname]:.4g} (max |ref| {ref_max:.4g}, tolerance {BWD_RTOL_OF_MAX} of "
                 f"it, or of {BWD_SCALE_FLOOR} if larger)")
        errs[gname + "_ref_max"] = ref_max
    del refs

    def fwd():
        return la.local_attention(q, k, v, window, mask)

    def bwd():
        return la.local_bwd(q, k, v, window, mask, out, lse, dout)
    ms, bwd_ms = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
    dev_ms, bwd_dev_ms = graph_ms(fwd), graph_ms(bwd)
    plain_ms = cuda_ms(lambda: la.local_attention_ref(q, k, v, window, mask), iters=3, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: la.local_attention_bwd_ref(q, k, v, window, mask, out, lse,
                                                              dout), iters=3, warmup=1)
    # library yardstick: SDPA with the dense band mask, forward and the
    # backward of one call on a retained graph (copies and mask made first)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    amask = vis[:, None]
    def library():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                  enable_gqa=hkv != hq)
    library_ms, library_dev_ms = library_min_ms(library), graph_ms(library)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    library_bwd_ms = library_min_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t,
                                                                retain_graph=True))
    del o, qt, kt, vt, amask

    # the work this data needs: the band's visible (query, key) pairs; the
    # bytes it needs: q (out, dO, lse) of the rows that see a key, k and v of
    # the keys some query sees, the mask, and every output written once
    pairs = float(vis.sum())
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    del vis
    fwd_bytes = (2 * (q_rows * hq * d + 2 * kv_rows * hkv * d + out.numel())
                 + 4 * lse.numel() + 4 * mask.numel())
    bwd_bytes = (2 * (3 * q_rows * hq * d + 2 * kv_rows * hkv * d)
                 + 4 * q_rows * hq + 4 * mask.numel()
                 + 2 * (q.numel() + 2 * k.numel()))
    shape = {"B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d, "window": window,
             "visible_pairs": pairs, "rows_without_key": n_empty}
    out_rows = []
    for kind, flops, nbytes, kms, gms, pms, lms, e in (
            ("fwd", 4.0 * d * hq * pairs, fwd_bytes, ms, dev_ms, plain_ms, library_ms,
             {"max_abs_err": err, "lse_max_abs_err": lse_err,
              "library_graph_ms": library_dev_ms}),
            ("bwd", 10.0 * d * hq * pairs, bwd_bytes, bwd_ms, bwd_dev_ms, plain_bwd_ms,
             library_bwd_ms, {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]), **errs})):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        out_rows.append({"shape": name, "kernel": f"local_{kind}", **shape, **e, "ms": kms,
                         "graph_ms": gms, "plain_ms": pms, "library_ms": lms,
                         "bound_ms": max(t_ops, t_bytes),
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "tflops": flops / (kms * 1e-3) / 1e12})
    f_, b_ = out_rows
    log(f"kernel {name} (band): B={b} T={t} Hq={hq} Hkv={hkv} D={d} W={window}: "
        f"{pairs:.4g} visible pairs, {n_empty} rows without a key; local_fwd max abs err "
        f"{err:.3g} (lse {lse_err:.3g}), ms {ms:.4f} (graph {dev_ms:.4f}) plain_ms "
        f"{plain_ms:.3f} library_ms {library_ms:.4f} (graph {library_dev_ms:.4f}) bound_ms "
        f"{f_['bound_ms']:.4f} ({f_['bound_by']}), "
        f"{f_['tflops']:.1f} TFLOP/s; local_bwd max abs err dq {errs['dq']:.3g} dk "
        f"{errs['dk']:.3g} dv {errs['dv']:.3g} (max |ref| {errs['dq_ref_max']:.3g} "
        f"{errs['dk_ref_max']:.3g} {errs['dv_ref_max']:.3g}), ms {bwd_ms:.4f} (graph "
        f"{bwd_dev_ms:.4f}) plain_ms "
        f"{plain_bwd_ms:.3f} library_ms {library_bwd_ms:.4f} bound_ms {b_['bound_ms']:.4f} "
        f"({b_['bound_by']}), {b_['tflops']:.1f} TFLOP/s")
    return out_rows


def long_items():
    """The long-DNA corpus of phase 7: 16 KEGG-shaped items of 2 x 12,288 bp."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    return synthetic_kegg_items(n=16, seq_len=LONG_DNA_BP, seed=0)


def long_batch(items):
    """Two items collated as the CLI collates them in phase 7 (B=2, text 512,
    DNA 2048 tokens per sequence, bucket 128)."""
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm
    proc = BioProcessor(ByteTextTokenizer(), KmerTokenizer())
    return sft_collate([format_kegg_for_dna_llm(x) for x in items[:2]], proc,
                       max_length_text=512, max_length_dna=2048, bucket=128)


def served_inputs(n: int = 8):
    """The 8-request batch phase 4 serves, as `prepare_batch` hands it to
    the engine: KEGG-shaped items of 2 x 2048 bp."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.serve import build_config, prepare_batch
    items = synthetic_kegg_items(n=n, seq_len=2048, seed=0)
    cfg, processor = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    return items, prepare_batch(processor, cfg, items)


def phase_kernels(torch, max_new):
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = [
        # (a) encoder, single-block regime: 16 x T=128, bidirectional, key mask
        kernel_case(torch, "encoder_T128", 16, 128, 128, 16, 16, 64, False, None,
                    right_padded(torch, 16, 128, 64, g), 11),
        # (b) encoder, tiled regime, as served: 16 x T=344 (2 kb per side), ragged
        kernel_case(torch, "encoder_T344", 16, 344, 344, 16, 16, 64, False, None,
                    right_padded(torch, 16, 344, 200, g), 12),
        # (c) decoder prefill into a cache of P + 64: causal, q_offset 0,
        # left-padded (pad queries are fully masked rows)
        kernel_case(torch, "prefill_1024", 8, 1024, 1088, 16, 8, 128, True, 0,
                    left_padded(torch, 8, 1024, 64, 300, g), 13),
        # (d) causal with q_offset > 0
        kernel_case(torch, "q_offset_960", 8, 128, 1088, 16, 8, 128, True, 960,
                    left_padded(torch, 8, 1088, 0, 200, g), 14),
    ]
    # (e) the prefill and encoder shapes and masks the serve phase gives the kernel
    _, (ids, mask, dna_ids, dna_mask) = served_inputs()
    b, p = ids.shape
    log(f"kernels: the served batch is B={b} P={p} text tokens, DNA {list(dna_ids.shape)}")
    cmask = torch.as_tensor(np.pad(mask, ((0, 0), (0, max_new))), device="cuda")
    rows.append(kernel_case(torch, f"prefill_served_P{p}", b, p, p + max_new, 16, 8, 128,
                            True, 0, cmask, 15))
    s_, t_ = dna_ids.shape
    rows.append(kernel_case(torch, f"encoder_served_T{t_}", s_, t_, t_, 16, 16, 64, False,
                            None, torch.as_tensor(dna_mask, device="cuda"), 16))
    # (f) the encoder as the train phase's bench-shape batch gives it: 2 x 4
    # DNA sequences of 128 tokens, all valid (the decoder's training shapes
    # are held in the backward cases below, forward first)
    rows.append(kernel_case(torch, "encoder_sft_T128", 8, 128, 128, 16, 16, 64, False, None,
                            torch.ones((8, 128), dtype=torch.int32, device="cuda"), 17))

    bwd_rows = [
        # bench.py's SFT shape, the single-block regime on the TPU: all valid
        bwd_case(torch, "sft_T768", 4, 768, 768, 16, 8, 128, True, 0,
                 torch.ones((4, 768), dtype=torch.int32, device="cuda"), 21),
        # the tiled regime on the TPU: ragged edge, left pads (fully masked rows)
        bwd_case(torch, "sft_T1000_leftpad", 4, 1000, 1000, 16, 8, 128, True, 0,
                 left_padded(torch, 4, 1000, 0, 300, g), 22),
        # the encoder under --dna_model_finetune: bidirectional, right pads
        bwd_case(torch, "encoder_T128_bwd", 16, 128, 128, 16, 16, 64, False, 0,
                 right_padded(torch, 16, 128, 64, g), 23),
        # the rest of the kernel's contract, off the SFT path: Tq < Tk with
        # a causal q_offset > 0 and a ragged key edge
        bwd_case(torch, "q_offset_194_bwd", 2, 136, 330, 16, 8, 128, True, 194,
                 left_padded(torch, 2, 330, 0, 40, g), 24),
    ]
    # the long-DNA decoder (phase 7): causal over the DNA placeholders of
    # 2 x 2048 tokens per item, with the left pads the collate gives
    am = torch.as_tensor(long_batch(long_items())["attention_mask"], device="cuda")
    rows.append(kernel_case(torch, f"dec_long_T{am.shape[1]}_collate", 2, am.shape[1],
                            am.shape[1], 16, 8, 128, True, 0, am, 25))
    rows.append(kernel_case(torch, "dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True, 0,
                            torch.ones((2, 4608), dtype=torch.int32, device="cuda"), 26))
    bwd_rows.append(bwd_case(torch, f"dec_long_T{am.shape[1]}_collate", 2, am.shape[1],
                             am.shape[1], 16, 8, 128, True, 0, am, 25))
    bwd_rows.append(bwd_case(torch, "dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True, 0,
                             torch.ones((2, 4608), dtype=torch.int32, device="cuda"), 26))

    # the banded kernels: local_fwd and local_bwd against their plain versions
    enc_mask = right_padded(torch, 4, 2048, 1024, g)
    band_rows = [
        # (a) bench.py's smoke shape (bench.py:38-41, 67): GQA, D=128
        *local_case(torch, "bench_smoke_T512_W96", 2, 512, 16, 8, 128, 96,
                    torch.ones((2, 512), dtype=torch.int32, device="cuda"), 31),
        # (b) the long-DNA encoder: 2 x 2 sequences of 2048 tokens, right pads
        *local_case(torch, "encoder_long_T2048_W256", 4, 2048, 16, 16, 64, LONG_WINDOW,
                    enc_mask, 32),
        # (c) 4x the length: time should grow about linearly in T
        *local_case(torch, "encoder_T8192_W256", 1, 8192, 16, 16, 64, LONG_WINDOW,
                    torch.ones((1, 8192), dtype=torch.int32, device="cuda"), 33),
        # (d) left pads longer than the band: rows that see no valid key
        *local_case(torch, "leftpad_T1000_W300", 2, 1000, 16, 16, 64, 300,
                    (torch.arange(1000, device="cuda")[None, :]
                     >= torch.tensor([[620], [40]], device="cuda")).to(torch.int32), 34),
        # (e) a band wider than the sequence: full bidirectional attention
        *local_case(torch, "encoder_T344_W4096", 16, 344, 16, 16, 64, 4096,
                    right_padded(torch, 16, 344, 200, g), 35),
        # a band edge on the 128-key tile boundary, GQA at D=128, ragged T,
        # left pads as the collate gives them (rows that see no valid key)
        *local_case(torch, "band_edge_T1000_W128", 2, 1000, 16, 8, 128, 128,
                    left_padded(torch, 2, 1000, 0, 300,
                                torch.Generator(device="cuda").manual_seed(36)), 36),
        # the diagonal alone: every query sees only itself
        *local_case(torch, "band_diag_T777_W0", 2, 777, 16, 16, 64, 0,
                    torch.ones((2, 777), dtype=torch.int32, device="cuda"), 37),
    ]
    # the long-DNA encoder's shape without the band, for the O(T * W) saving
    rows.append(kernel_case(torch, "encoder_long_T2048_full", 4, 2048, 2048, 16, 16, 64, False,
                            None, enc_mask, 32))
    bwd_rows.append(bwd_case(torch, "encoder_long_T2048_full_bwd", 4, 2048, 2048, 16, 16, 64,
                             False, 0, enc_mask, 32))
    return rows, bwd_rows, band_rows


def f32_bound(flops, nbytes):
    """(bound_ms, bound_by, ffma_bound_ms) of an fp32 kernel: the larger of
    three TF32 passes of its FLOPs at PEAK_TF32_FLOPS and its bytes at
    PEAK_HBM_BYTES; and the FFMA bound (FLOPs at PEAK_FP32_FLOPS)."""
    t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / PEAK_FP32_FLOPS * 1e3)


def f32_case(torch, name, b, tq, tk, hq, hkv, d, causal, mask, seed, window=None,
             backward=True, q_offset=0):
    """flash_f32_fwd (and flash_f32_bwd) against the plain fp32 versions on
    one shape: the flash route (`flash_attention` / `flash_bwd` on fp32
    tensors, causal with `q_offset`) or, with `window`, the band
    (`local_attention` / `local_bwd`). Out on the rows that see a key and
    the LSE there within F32_*_RTOL_OF_MAX of their largest magnitude, rows
    that see none exactly (0, -1e30) with dq = 0, the gradients within
    F32_BWD_RTOL_OF_MAX and bitwise equal over two calls; event and graph
    times, the plain versions', SDPA's on the same fp32 inputs (the lowest
    of three repetitions; the forward's also from a CUDA graph) and the bound (`f32_bound`: three TF32 passes at
    495e12 against fp32 bytes at 3.35e12, and the FFMA bound beside it).
    Returns the forward's row and the backward's (or None)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops import local_attention as la
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev)
                     for shape in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                                   (b, tq, hq, d)))
    if window is None:
        # causal with q_offset: 0 for a prefill into a cache of Tk >= Tq
        # slots, Tk - Tq for a chunk after earlier ones
        vis = mask.bool()[:, None, :].expand(b, tq, tk)
        if causal:
            vis = vis & (torch.arange(tk, device=dev)[None, :]
                         <= torch.arange(tq, device=dev)[:, None] + q_offset)
        fwd = lambda: fa.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset,
                                         return_lse=True)
        ref_fwd = lambda: fa.flash_attention_ref(q, k, v, mask, causal, q_offset)
        bwd = lambda o, l: fa.flash_bwd(q, k, v, mask, causal, q_offset, o, l, dout)
        ref_bwd = lambda o, l: fa.flash_attention_bwd_ref(q, k, v, mask, causal, q_offset, o, l,
                                                          dout)
    else:
        vis = band_visible(torch, tq, window, mask)
        fwd = lambda: la.local_attention(q, k, v, window, mask, return_lse=True)
        ref_fwd = lambda: la.local_attention_ref(q, k, v, window, mask)
        bwd = lambda o, l: la.local_bwd(q, k, v, window, mask, o, l, dout)
        ref_bwd = lambda o, l: la.local_attention_bwd_ref(q, k, v, window, mask, o, l, dout)
    before = (fa.flash_f32_fwd.launches, fa.flash_f32_bwd.launches,
              fa.flash_attention.launches, fa.flash_bwd.launches)
    out, lse = fwd()
    torch.cuda.synchronize()
    if (fa.flash_f32_fwd.launches - before[0] != 1
            or fa.flash_attention.launches != before[2]):
        fail(f"kernel {name} (fp32): the wrapper did not launch flash_f32_fwd once")
    rows = vis.any(-1)
    ref_out, ref_lse = ref_fwd()
    out_max = float(ref_out[rows].abs().max())
    err = float((out[rows] - ref_out[rows]).abs().max())
    lrows = rows[:, None, :].expand(b, hq, tq)
    lse_max = float(ref_lse[lrows].abs().max())
    lse_err = float((lse[lrows] - ref_lse[lrows]).abs().max())
    if err > F32_OUT_RTOL_OF_MAX * out_max or lse_err > F32_LSE_RTOL_OF_MAX * lse_max:
        fail(f"kernel {name} (fp32): out err {err:.3g} (max |ref| {out_max:.3g}) or lse err "
             f"{lse_err:.3g} (max |ref| {lse_max:.3g}) over the tolerance")
    empty = ~rows
    n_empty = int(empty.sum())
    if n_empty and (bool(out[empty].ne(0).any())
                    or bool(lse.transpose(1, 2)[empty].ne(fa.NEG_INF).any())):
        fail(f"kernel {name} (fp32): rows with no visible key are not (0, -1e30)")
    del ref_out, ref_lse
    pairs = float(vis.sum())
    q_rows, kv_rows = float(rows.sum()), float(vis.any(1).sum())
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    amask = vis[:, None]

    def library():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                  enable_gqa=hkv != hq)
    shape = {"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d, "causal": causal,
             "q_offset": q_offset if window is None else None, "window": window,
             "visible_pairs": pairs, "rows_without_key": n_empty}
    kfwd = lambda: fwd()
    ms, gms = cuda_ms(kfwd, iters=20), graph_ms(kfwd)
    plain_ms = cuda_ms(ref_fwd, iters=3, warmup=1)
    lib_ms, lib_gms = library_min_ms(library), graph_ms(library)
    flops = 4.0 * d * hq * pairs
    nbytes = 4 * (q_rows * hq * d + 2 * kv_rows * hkv * d + out.numel() + lse.numel()
                  + mask.numel())
    bound, bound_by, ffma = f32_bound(flops, nbytes)
    frow = {"shape": name, "kernel": "flash_f32_fwd", **shape, "max_abs_err": err,
            "out_max": out_max, "lse_max_abs_err": lse_err, "ms": ms, "graph_ms": gms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library_graph_ms": lib_gms,
            "bound_ms": bound, "bound_by": bound_by, "ffma_bound_ms": ffma,
            "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"kernel {name} (fp32 fwd): B={b} Tq={tq} Tk={tk} Hq={hq} Hkv={hkv} D={d} "
        f"causal={causal} q_offset={shape['q_offset']} window={window}: {pairs:.4g} visible "
        f"pairs, {n_empty} rows without a key; max abs err {err:.3g} of max |ref| "
        f"{out_max:.3g} (lse {lse_err:.3g} of {lse_max:.3g}); ms {ms:.4f} (graph {gms:.4f}) "
        f"plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} (graph {lib_gms:.4f}) bound_ms "
        f"{bound:.4f} ({bound_by}, 3xTF32; FFMA bound {ffma:.4f}), {frow['tflops']:.2f} "
        f"TFLOP/s")
    if not backward:
        return frow, None
    grads = bwd(out, lse)
    torch.cuda.synchronize()
    if fa.flash_f32_bwd.launches - before[1] != 1 or fa.flash_bwd.launches != before[3]:
        fail(f"kernel {name} (fp32): the wrapper did not launch flash_f32_bwd once")
    refs = ref_bwd(out, lse)
    errs = {}
    for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        if not bool(torch.isfinite(got).all()):
            fail(f"kernel {name} (fp32): {gname} is not finite")
        errs[gname] = float((got - ref).abs().max())
        errs[gname + "_ref_max"] = float(ref.abs().max())
        if errs[gname] > F32_BWD_RTOL_OF_MAX * max(errs[gname + "_ref_max"],
                                                   F32_BWD_SCALE_FLOOR):
            fail(f"kernel {name} (fp32): {gname} differs from the plain version by "
                 f"{errs[gname]:.4g} (max |ref| {errs[gname + '_ref_max']:.4g}, floor "
                 f"{F32_BWD_SCALE_FLOOR})")
    if n_empty and bool(grads[0][empty].ne(0).any()):
        fail(f"kernel {name} (fp32): rows with no visible key have dq != 0")
    again = bwd(out, lse)
    torch.cuda.synchronize()
    for gname, got, got2 in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(got, got2):
            fail(f"kernel {name} (fp32): two backward calls give different {gname}: every "
                 f"gradient element is written once, in a fixed order")
    del refs, again
    kbwd = lambda: bwd(out, lse)
    bms, bgms = cuda_ms(kbwd, iters=20), graph_ms(kbwd)
    plain_bms = cuda_ms(lambda: ref_bwd(out, lse), iters=3, warmup=1)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=hkv != hq)
    do_t = dout.transpose(1, 2).contiguous()
    lib_bms = library_min_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t,
                                                         retain_graph=True))
    del o
    flops = 10.0 * d * hq * pairs
    nbytes = 4 * (3 * q_rows * hq * d + 2 * kv_rows * hkv * d + q_rows * hq + mask.numel()
                  + q.numel() + 2 * k.numel())
    bound, bound_by, ffma = f32_bound(flops, nbytes)
    brow = {"shape": name, "kernel": "flash_f32_bwd", **shape,
            "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]), **errs, "ms": bms,
            "graph_ms": bgms, "plain_ms": plain_bms, "library_ms": lib_bms,
            "bound_ms": bound, "bound_by": bound_by, "ffma_bound_ms": ffma,
            "bitwise_repeat": True, "tflops": flops / (bms * 1e-3) / 1e12}
    log(f"kernel {name} (fp32 bwd): max abs err dq {errs['dq']:.3g} dk {errs['dk']:.3g} dv "
        f"{errs['dv']:.3g} (max |ref| {errs['dq_ref_max']:.3g} {errs['dk_ref_max']:.3g} "
        f"{errs['dv_ref_max']:.3g}), bitwise equal over two calls; ms {bms:.4f} (graph "
        f"{bgms:.4f}) plain_ms {plain_bms:.3f} library_ms {lib_bms:.4f} bound_ms {bound:.4f} "
        f"({bound_by}, 3xTF32; FFMA bound {ffma:.4f}), {brow['tflops']:.2f} TFLOP/s")
    return frow, brow


def f32_kernel_cases(torch, max_new):
    """The fp32 kernels at the shapes the fp32 route gives them: the served
    prefill with its left pads, the rehearsal's SFT step forward and
    backward, a batch row with no visible key, and the long-DNA band (b);
    then the tile walk's edges: a causal chunk at q_offset 194 (Tq 136 is
    two 64-row tiles and a ragged one), the band at W = 64 (the D = 64
    key tile) and W = 0, and the two instantiations the route does not
    reach above (flash at D = 64, the band at D = 128)."""
    g = torch.Generator(device="cuda").manual_seed(41)
    _, (ids, mask, _, _) = served_inputs()
    b, p = ids.shape
    cmask = torch.as_tensor(np.pad(mask, ((0, 0), (0, max_new))), device="cuda")
    empty = left_padded(torch, 2, 300, 0, 100, g)
    empty[1] = 0
    cases = [
        ("f32_prefill_served_P%d" % p, b, p, p + max_new, 16, 8, 128, True, cmask, 42, None,
         False, 0),
        ("f32_sft_T512_leftpad", 8, 512, 512, 16, 8, 128, True,
         left_padded(torch, 8, 512, 0, 100, g), 43, None, True, 0),
        ("f32_empty_row_T300", 2, 300, 300, 16, 8, 128, True, empty, 44, None, True, 0),
        ("f32_band_T2048_W256", 4, 2048, 2048, 16, 16, 64, False,
         right_padded(torch, 4, 2048, 1024, g), 45, LONG_WINDOW, True, 0),
        ("f32_chunk_q_offset194", 2, 136, 330, 16, 8, 128, True,
         right_padded(torch, 2, 330, 300, g), 46, None, True, 194),
        ("f32_band_T1000_W64", 2, 1000, 1000, 8, 4, 64, False,
         right_padded(torch, 2, 1000, 700, g), 47, 64, True, 0),
        ("f32_band_T1000_W0", 2, 1000, 1000, 8, 4, 64, False,
         right_padded(torch, 2, 1000, 700, g), 48, 0, True, 0),
        ("f32_bidir_T300_D64", 3, 300, 300, 8, 8, 64, False, empty.repeat(2, 1)[:3], 49, None,
         True, 0),
        ("f32_band_T520_W100_D128", 2, 520, 520, 8, 2, 128, False,
         right_padded(torch, 2, 520, 400, g), 50, 100, True, 0)]
    rows = []
    for (name, b_, tq, tk, hq, hkv, d, causal, m, seed, window, backward, q_offset) in cases:
        frow, brow = f32_case(torch, name, b_, tq, tk, hq, hkv, d, causal, m, seed, window,
                              backward, q_offset)
        rows += [frow] + ([brow] if brow else [])
    return rows


# -- phase 4 -----------------------------------------------------------------

def burst(server, reqs, max_new):
    """Send `reqs` to `server` at once, one thread each, greedy; the
    results in request order."""
    results = [None] * len(reqs)

    def one(i):
        results[i] = server.generate(reqs[i], max_new_tokens=max_new, greedy=True)
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results


def record_engine_calls(server):
    """Wrap `server.engine.generate` so each call appends ((ids, mask),
    its last_stats) to the returned list; `restore` undoes the wrap. With
    random weights most greedy ids lie past the byte tokenizer's 266 ids
    and decode to "", so repeats are compared on ids, not only on texts."""
    calls, engine_generate = [], server.engine.generate

    def recording_generate(*args, **kw):
        out = engine_generate(*args, **kw)
        calls.append((out, dict(server.engine.last_stats)))
        return out
    server.engine.generate = recording_generate

    def restore():
        server.engine.generate = engine_generate
    return calls, restore


def completion_rows(calls):
    """Completion rows of recorded engine calls as a sorted multiset (the
    batch order follows the requests' arrival, which threads do not fix)."""
    return sorted(tuple(ids[i][mask[i].astype(bool)].tolist())
                  for (ids, mask), _ in calls for i in range(ids.shape[0]))


def phase_serve(torch, card, max_new):
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import build_server, make_http_server, prepare_batch

    t0 = time.perf_counter()
    # a batch window long enough that each burst of 8 threads is one batch
    # on a slow host too: greedy tokens are compared across bursts, and
    # another split of the same requests pads them differently
    server = build_server("qwen3-0.6b", "nt-500m", max_length_dna=2048, seed=0,
                          max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                          greedy_default=True)
    cfg = server.cfg
    dec, enc = cfg.decoder, cfg.encoder
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim,
            dec.vocab_size) != (28, 1024, 16, 8, 128, 151936):
        fail(f"decoder is not at Qwen3-0.6B width: {dec}")
    if (enc.num_layers, enc.hidden_size, enc.num_heads, enc.head_dim) != (29, 1024, 16, 64):
        fail(f"encoder is not at NT-v2-500M width: {enc}")
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serve: model of {n_params / 1e6:.1f} M parameters (bf16, seed 0) built in "
        f"{time.perf_counter() - t0:.2f} s")
    items, _ = served_inputs()

    # the kernel route against the plain route on one request at full width
    ids, mask, dna, dmask = (torch.as_tensor(a, device="cuda")
                             for a in prepare_batch(server.processor, cfg, items[:1]))
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(enc, attention_impl="xla"),
        decoder=dataclasses.replace(dec, attention_impl="xla"))
    eos = server.processor.text_tokenizer.eos_token_id
    before = fa.flash_attention.launches
    k_logits = server.engine.prefill(server.model, ids, mask, dna, dmask, max_new)[0]
    if fa.flash_attention.launches - before != ENCODER_LAYERS + DECODER_LAYERS:
        fail("the kernel route did not launch flash_fwd once per encoder and prefill layer")
    p_logits = GenerationEngine(plain_cfg, eos).prefill(server.model, ids, mask, dna, dmask,
                                                        max_new)[0]
    if not (bool(torch.isfinite(k_logits).all()) and bool(torch.isfinite(p_logits).all())):
        fail("non-finite prefill logits")
    cos = float(torch.nn.functional.cosine_similarity(k_logits, p_logits, dim=-1).min())
    diff = float((k_logits - p_logits).abs().max())
    same_top = bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())
    log(f"serve: kernel vs plain route, last-column prefill logits [{k_logits.shape[0]}, "
        f"{k_logits.shape[1]}]: min cosine {cos:.6f}, max abs diff {diff:.4g} "
        f"(|logit| max {float(p_logits.abs().max()):.3g}), same argmax {same_top}")
    if cos < 0.99:
        fail(f"kernel and plain routes disagree at full width (cosine {cos:.4f})")

    server.start()
    calls_out, restore = record_engine_calls(server)

    # --- the main path: counts from 0 just before, read just after ---------
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    calls0 = server.engine_calls
    first = burst(server, items, max_new)
    n_first = len(calls_out)
    second = burst(server, items, max_new)
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    body = json.dumps({"question": items[0]["question"],
                       "reference_sequence": items[0]["reference_sequence"],
                       "variant_sequence": items[0]["variant_sequence"],
                       "max_new_tokens": max_new, "greedy": True}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        http_result = json.loads(r.read())
        http_status = r.status
    launches = fa.flash_attention.launches
    calls = server.engine_calls - calls0
    peak = torch.cuda.max_memory_allocated()
    httpd.shutdown()
    httpd.server_close()
    server.stop()
    restore()
    # -----------------------------------------------------------------------

    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    if len(answered) != 16 or http_status != 200 or set(http_result) != {"completion", "answer"}:
        fail(f"not every request was answered: {first} {second} {http_result}")
    first_rows = completion_rows(calls_out[:n_first])
    if (len(first_rows) != 8 or first_rows != completion_rows(calls_out[n_first:-1])
            or first != second):
        fail(f"greedy repeats of the same 8 requests differ (engine call batch sizes "
             f"{[ids.shape[0] for (ids, _), _ in calls_out]})")
    if server.engine.nonfinite_rows:
        fail(f"{server.engine.nonfinite_rows} logit rows were not finite")
    if launches != (ENCODER_LAYERS + DECODER_LAYERS) * calls:
        fail(f"flash_fwd launched {launches} times in {calls} engine calls, "
             f"expected {ENCODER_LAYERS + DECODER_LAYERS} per call")
    log(f"serve: {len(answered)} + 1 requests answered in {calls} engine calls "
        f"({n_first} for the first 8); flash_fwd launches {launches} "
        f"= {launches // max(calls, 1)} per call; {sum(map(len, first_rows))} greedy "
        f"tokens per burst, identical in the repeat")
    for name, (_, st) in (("first 8", calls_out[n_first - 1]), ("same 8 again", calls_out[-2]),
                          ("http 1", calls_out[-1])):
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"serve [{card}] {name}: B={st['batch']} P={st['prompt_len']}: prefill "
            f"(encoder + splice + prefill + first token) {st['prefill_s'] * 1e3:.1f} ms; "
            f"decode {tps:.1f} tokens/s over {st['steps'] - 1} steps "
            f"({st['decode_s'] / max(st['steps'] - 1, 1) * 1e3:.2f} ms per step)")
    log(f"serve [{card}]: torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    return launches, server, items


def phase_profile(torch, card, server, items, max_new):
    """torch.profiler over one prefill and over one engine call of
    `max_new` tokens of the 8-request batch (`profile_step`): device time
    by kernel and the device's busy share."""
    from bioreason_tpu_torch.serve import prepare_batch
    args = [torch.as_tensor(a, device="cuda")
            for a in prepare_batch(server.processor, server.cfg, items)]
    eng = server.engine
    profile_step(torch, card, "prefill", lambda: eng.prefill(server.model, *args, max_new),
                 ("flash_fwd",))
    profile_step(torch, card, "generate",
                 lambda: eng.generate(server.model, *args, max_new_tokens=max_new, greedy=True),
                 ("flash_fwd",))


def profile_step(torch, card, label, step, names, ranges=()):
    """One step under torch.profiler, read from its raw events (a GRPO step
    makes ~300k launches, and building the profiler's per-op tables for them
    takes minutes). Prints the wall, the device busy time and share (every
    device event that is not a user range), the launches, the top kernels,
    the share of the kernels whose names hold each of `names`, and the
    device time of the kernels launched inside each `record_function` range
    named in `ranges` (a kernel belongs to a range when the host op that
    launched it started inside it). Returns the busy and wall ms, the parts
    and each kernel as (name, duration ns, the ranges it belongs to, device
    start ns)."""
    import bisect
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {r: [] for r in ranges}
    op_start, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation():
                if e.name() in spans:
                    spans[e.name()].append((e.start_ns(), e.end_ns()))
            else:
                op_start[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            kernels.append((e.name(), e.duration_ns(), e.linked_correlation_id(),
                            e.start_ns()))
    busy_ms = sum(k[1] for k in kernels) / 1e6
    by_name = {}
    for name, dur, *_ in kernels:
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + dur)
    share = {n: sum(t for k, (_, t) in by_name.items() if n in k) / 1e6 for n in names}
    log(f"profile [{card}] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel launches; "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy_ms, 1e-9):.1f}% of device time)"
                    for k, v in share.items()))
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t / 1e6:9.3f} ms {n:6d}x  {name[:90]}")
    parts, in_ranges = {}, [set() for _ in kernels]
    for r, iv in spans.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0
        for k, (_, dur, corr, _) in enumerate(kernels):
            t = op_start.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < iv[i][1]:
                total += dur
                in_ranges[k].add(r)
        parts[r] = (len(iv), total / 1e6)
    by_kernel = [(name, dur, frozenset(rs), start)
                 for (name, dur, _, start), rs in zip(kernels, in_ranges)]
    if not ranges:
        return busy_ms, wall_ms, parts, by_kernel
    linked = sum(1 for k in kernels if k[2] in op_start)
    log(f"profile [{card}] {label} parts (device ms of the kernels launched inside each "
        f"range, share of busy; {linked} of {len(kernels)} kernels linked to a host op): "
        + ", ".join(f"{r} x{n} {ms:.3f} ({100 * ms / max(busy_ms, 1e-9):.1f}%)"
                    for r, (n, ms) in parts.items()))
    return busy_ms, wall_ms, parts, by_kernel


# -- phase 6 -----------------------------------------------------------------

def bench_batch(cfg, b=4, t_text=768, l_dna=128):
    """bench.py's SFT batch (bench.py:253-268): random text ids, 2 DNA
    sequences of l_dna tokens per item spliced after the first token, the
    last 128 positions supervised, labels gathered to those positions."""
    from bioreason_tpu_torch.ops.fused_ce import gather_label_positions
    npr = np.random.default_rng(0)
    input_ids = npr.integers(0, 150000, (b, t_text)).astype(np.int32)
    for i in range(b):
        input_ids[i, 1:1 + 2 * l_dna] = cfg.dna_pad_token_id
    labels = np.where(np.arange(t_text)[None] >= t_text - 128, input_ids, -100)
    pos, tgt, val = gather_label_positions(labels)
    return {"input_ids": input_ids, "attention_mask": np.ones((b, t_text), np.int32),
            "dna_input_ids": npr.integers(6, 4102, (2 * b, l_dna)).astype(np.int32),
            "dna_attention_mask": np.ones((2 * b, l_dna), np.int32),
            "label_positions": pos, "label_targets": tgt, "label_valid": val}


def _wrappers():
    """Each bf16 kernel's wrapper, which counts its launches."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops import local_attention as la
    return {"flash_fwd": fa.flash_attention, "flash_bwd": fa.flash_bwd,
            "local_fwd": la.local_attention, "local_bwd": la.local_bwd}


def _f32_wrappers():
    """The fp32 kernels' launchers (flash and band), which count theirs."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    return {"flash_f32_fwd": fa.flash_f32_fwd, "flash_f32_bwd": fa.flash_f32_bwd}


def reset_counts():
    for fn in (*_wrappers().values(), *_f32_wrappers().values()):
        fn.launches = 0


def counts():
    """The bf16 kernels' launches (the fp32 ones: `all_counts`)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def all_counts():
    return {**counts(), **{name: fn.launches for name, fn in _f32_wrappers().items()}}


def phase_train(torch, card, ckpt):
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.models.fusion import fusion_forward
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.train.sft import SFTTrainer
    per_step_fwd = ENCODER_LAYERS + DECODER_LAYERS

    # (a) the CLI, end to end: collate, labels, gathered CE, optimizer. Its
    # presets keep remat on, so each decoder layer's forward runs twice. Its
    # sft_final stays for phase 8's reason CLI; main removes `ckpt`.
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_sft.main(["--max_steps", "4", "--seed", "0", "--checkpoint_dir", ckpt])
    secs = time.perf_counter() - t0
    fwd, bwd = fa.flash_attention.launches, fa.flash_bwd.launches
    losses = [m["loss"] for m in trainer.history]
    log(f"train (cli) [{card}]: 4 steps in {secs:.1f} s (build and data included), losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}; flash_fwd {fwd}, "
        f"flash_bwd {bwd} launches")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"train_sft.main did not run 4 finite steps: {losses}")
    if bwd != 4 * DECODER_LAYERS or fwd != 4 * (per_step_fwd + DECODER_LAYERS):
        fail(f"train_sft.main launched flash_fwd {fwd} and flash_bwd {bwd} times in 4 steps")
    del trainer
    torch.cuda.empty_cache()

    # (b) the SFTTrainer at bench.py's shape, remat off
    dec = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
    enc = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=151938)
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(r=32, alpha=64),
                    optim=OptimConfig(total_steps=100), seed=0)
    trainer = SFTTrainer(cfg, sft)
    batch = bench_batch(cfg)
    n_train = sum(p.numel() for p in trainer.params)
    b_leaves = {n: p.detach().clone() for n, p in trainer.trainable_state().items()
                if n.endswith("lora_b")}
    for _ in range(2):                                   # warm-up
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(batch) for _ in range(10)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = fa.flash_attention.launches, fa.flash_bwd.launches
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    log(f"train (bench shape) [{card}]: B=4 T=768 DNA 8x128, LoRA r32/a64 over "
        f"{n_train / 1e6:.2f} M trainable parameters, remat off: {40 / dt:.3f} examples/s, "
        f"{dt / 10 * 1e3:.1f} ms per step over 10 steps, torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {[round(x, 4) for x in losses]}")
    # (d) kernels per step, finite losses
    log(f"train (bench shape): flash_fwd {fwd} launches ({fwd / 10:g} per step), flash_bwd "
        f"{bwd} ({bwd / 10:g} per step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if bwd != 10 * DECODER_LAYERS or fwd != 10 * per_step_fwd:
        fail(f"expected {DECODER_LAYERS} flash_bwd and {per_step_fwd} flash_fwd launches per "
             f"step, got {bwd / 10:g} and {fwd / 10:g}")
    # (e) the adapters' B leaves have moved
    state = trainer.trainable_state()
    still = [n for n, b0 in b_leaves.items() if torch.equal(state[n].detach(), b0)]
    log(f"train (bench shape): {len(b_leaves) - len(still)} of {len(b_leaves)} LoRA B "
        f"leaves moved")
    if still:
        fail(f"LoRA B leaves did not move: {still[:4]}")

    # (c) one loss + gradient through the kernels against the plain route
    db = trainer._device_batch(batch)

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"])
        grads = torch.autograd.grad(loss, trainer.params)
        return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])
    lk, gk = loss_and_grad(cfg)
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(dec, attention_impl="xla"),
                                encoder=dataclasses.replace(enc, attention_impl="xla"))
    lp, gp = loss_and_grad(plain)
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"train: kernel vs plain route, one loss + gradient: loss {lk:.6f} vs {lp:.6f} "
        f"(diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable gradients {cos:.6f}, "
        f"norms {float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in training (cosine {cos:.4f})")
    del gk, gp

    # (f) one step under the profiler
    profile_step(torch, card, "train step", lambda: trainer.train_step(batch),
                 ("flash_fwd", "flash_bwd"))
    return {"fwd_launches": fwd, "bwd_launches": bwd}


# -- phase 7 -----------------------------------------------------------------

def phase_train_long(torch, card):
    """Long-DNA SFT with the encoder trained through the banded kernels."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.models import attention as attn_mod
    from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion
    from bioreason_tpu_torch.ops import local_attention as la
    per_step = {"local_fwd": 2 * ENCODER_LAYERS, "local_bwd": ENCODER_LAYERS,
                "flash_fwd": 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}

    # (a) the CLI on a .jsonl of long items: both towers keep remat on, so
    # each layer's forward runs twice a step
    items = long_items()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_long_", dir=build_dir)
    try:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "kegg_long.jsonl"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(json.dumps(x) for x in items))
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main([
            "--max_steps", "4", "--seed", "0", "--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--dna_attention", f"local:{LONG_WINDOW}", "--dna_model_finetune",
            "--max_length_dna", "2048", "--truncate_dna_per_side", "0", "--data_dir", data_dir])
        secs = time.perf_counter() - t0
        got = counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [m["loss"] for m in trainer.history]
    log(f"train-long (cli) [{card}]: 4 steps in {secs:.1f} s (data included), losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}; launches {got}")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        fail(f"train_sft.main --dna_attention local:{LONG_WINDOW} did not run 4 finite "
             f"steps: {losses}")
    if got != {k: 4 * n for k, n in per_step.items()}:
        fail(f"train_sft.main launched {got} in 4 steps, expected {per_step} per step "
             f"(no flash_* launch in the encoder)")
    init = init_fusion(trainer.fusion_cfg, seed=0, device="cuda")
    state = trainer.trainable_state()
    enc = [(n, p) for n, p in init.encoder.named_parameters()]
    still = [n for n, p in enc if torch.equal(state[f"encoder.{n}"].detach(), p.float())]
    log(f"train-long (cli): {len(enc) - len(still)} of {len(enc)} encoder leaves moved")
    if still:
        fail(f"encoder leaves did not move: {still[:4]}")
    del init, enc, state

    # (b) the same SFTTrainer on one batch of the corpus: 2 + 5 timed steps
    # (its schedule ended with the CLI's 4 steps: lr 0, the update still runs)
    batch = long_batch(items)
    n_train = sum(p.numel() for p in trainer.params)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clocks_before = smi_clocks()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    metrics, step_ms = [], []
    for _ in range(5):                   # each step ends in a host sync (loss, norm)
        ts = time.perf_counter()
        metrics.append(trainer.train_step(batch))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    # -----------------------------------------------------------------------
    log(f"train-long (trainer): step ms {[round(x, 1) for x in step_ms]}; card clocks.sm, "
        f"power.draw, temperature before [{clocks_before}] after [{smi_clocks()}]")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    b, t = np.asarray(batch["input_ids"]).shape
    s_, t_dna = np.asarray(batch["dna_input_ids"]).shape
    log(f"train-long (trainer) [{card}]: B={b} T={t}, encoder {s_} x {t_dna} DNA tokens on "
        f"local:{LONG_WINDOW}, {n_train / 1e6:.2f} M trainable parameters (LoRA r32 + "
        f"projection + encoder), remat on: {5 * b / dt:.3f} examples/s, {dt / 5 * 1e3:.1f} ms "
        f"per step over 5 steps, torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}; launches {got} "
        f"({', '.join(f'{k} {v / 5:g}' for k, v in got.items())} per step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite long-DNA training loss: {losses}")
    if got != {k: 5 * n for k, n in per_step.items()}:
        fail(f"the long-DNA trainer launched {got} in 5 steps, expected {per_step} per step")

    # (c) one loss + gradient through the kernels against the plain versions:
    # the decoder on 'xla', the encoder's band through local_attention_ref
    # (patched into this process's dispatch; autograd runs through it)
    db = trainer._device_batch(batch)
    cfg = trainer.fusion_cfg

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"], train_encoder=True)
        grads = torch.autograd.grad(loss, trainer.params)
        return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])
    lk, gk = loss_and_grad(cfg)
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                 attention_impl="xla"))
    kernel_route = attn_mod.local_attention
    attn_mod.local_attention = lambda q, k, v, w, kv_mask=None: la.local_attention_ref(
        q, k, v, w, kv_mask)[0]
    try:
        reset_counts()
        lp, gp = loss_and_grad(plain)
        if any(counts().values()):
            fail(f"the plain route launched kernels: {counts()}")
    finally:
        attn_mod.local_attention = kernel_route
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"train-long: kernel vs plain route, one loss + gradient: loss {lk:.6f} vs {lp:.6f} "
        f"(diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable gradients {cos:.6f}, "
        f"norms {float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in long-DNA training (cosine {cos:.4f})")
    del gk, gp

    # (d) one step under the profiler
    # flash_bwd's prep and convert passes also run around every local_bwd
    profile_step(torch, card, "train-long step", lambda: trainer.train_step(batch),
                 ("local_fwd", "local_bwd", "flash_fwd", "flash_bwd", "flash_bwd_prep",
                  "flash_bwd_convert"))
    return got


# -- phase 8 -----------------------------------------------------------------

# bench_grpo.py samples 64 new tokens; this phase samples 32, half the
# decode depth, so that the script with phase 11 keeps the time it took
# before it: the rollout's decode loop is host-bound (~60 ms a step) and its
# profiled step alone took 31.8 s at 64. The towers keep their full depth:
# at a quarter of it the update's kernel vs plain cosine fell to 0.81 on
# gradients 1000x smaller (norm 1.2e-3 against 1.28), a check the cut made
# meaningless, not a kernel fault
GRPO_PROMPTS, GRPO_G, GRPO_NEW = 4, 4, 16


def grpo_setup():
    """bench_grpo.py's configuration (bench_grpo.py:54-84): the fusion
    config, the GRPOConfig, the processor and the G-repeated items."""
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            GRPOConfig, LoRAConfig, OptimConfig, SamplingConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    tok = ByteTextTokenizer()
    cfg = FusionConfig(
        decoder=dataclasses.replace(DecoderConfig.qwen3_0_6b(vocab_size=tok.vocab_size),
                                    remat=True, remat_policy="full"),
        encoder=dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False),
        dna_pad_token_id=tok.dna_pad_id, max_length_text=512, max_length_dna=128)
    gcfg = GRPOConfig(num_generations=GRPO_G, batch_size=GRPO_PROMPTS * GRPO_G, beta=0.04,
                      max_completion_length=GRPO_NEW,
                      sampling=SamplingConfig(max_new_tokens=GRPO_NEW),
                      optim=OptimConfig(learning_rate=5e-6, total_steps=100),
                      lora=LoRAConfig(r=32, alpha=64), seed=0)
    items = [format_kegg_prompt_only(it)
             for it in synthetic_kegg_items(GRPO_PROMPTS, seq_len=600, seed=0)]
    return cfg, gcfg, BioProcessor(tok, KmerTokenizer()), [x for x in items for _ in range(GRPO_G)]


def acgt_share_reward(prompts, completions, **kw):
    """The share of A, C, G and T among a completion's characters. With
    random weights the registry's rewards are 0 for every completion, so the
    advantages, the gradient and the update would be 0: this one varies."""
    return [sum(c in "ACGT" for c in x) / max(len(x), 1) for x in completions]


def grpo_kernel_cases(torch, trainer, items, prefix="grpo"):
    """flash_fwd and flash_bwd at the shapes and masks one GRPO step of
    `trainer` gives them, from its own prompts and last rollout buffer: the
    grouped prefill (causal, Tq = Tk = P: the prompt cache has no decode
    slots, the prompts' left pads), the encoder as the rollout runs it (the
    unique prompts' DNA rows) and as the logp passes run it (the G-repeated
    rows), the logp passes' forward and the update's
    backward (causal over the prompt and its completion). Random weights
    never stop a completion at EOS, so half the rows get the completion
    mask an EOS gives (ones up to it, zeros after) at drawn lengths, the
    shortest 1."""
    dec, enc = trainer.fusion_cfg.decoder, trainer.fusion_cfg.encoder
    hq, hkv, d = dec.num_heads, dec.num_kv_heads, dec.head_dim
    out, _ = trainer._prepare_prompts(items[::GRPO_G])
    pmask = torch.as_tensor(np.asarray(out.attention_mask), dtype=torch.int32, device="cuda")
    bu, p = pmask.shape
    buf = trainer._buffers[0]["batch"]
    full = buf["full_mask"].to(torch.int32).clone()
    b, t = full.shape
    ends = np.random.default_rng(41).integers(1, t - p, b // 2)
    ends[0] = 1
    for i, e in zip(range(0, b, 2), ends):
        full[i, p + int(e):] = 0
    dna_u = torch.as_tensor(np.asarray(out.dna_attention_mask), dtype=torch.int32,
                            device="cuda")
    dna = buf["dna_attention_mask"].to(torch.int32)
    log(f"grpo kernels: prefill B={bu} P={p}; logps and update B={b} T={t}, completion "
        f"lengths {full[:, p:].sum(-1).tolist()}; encoder {list(dna_u.shape)} (rollout), "
        f"{list(dna.shape)} (logps)")
    rows = [kernel_case(torch, f"{prefix}_prefill_P{p}", bu, p, p, hq, hkv, d, True, 0, pmask,
                        41),
            *(kernel_case(torch, f"{prefix}_{part}_encoder_T{m.shape[1]}", m.shape[0],
                          m.shape[1], m.shape[1], enc.num_heads, enc.num_heads, enc.head_dim,
                          False, None, m, seed)
              for part, m, seed in (("rollout", dna_u, 45), ("logps", dna, 42))),
            kernel_case(torch, f"{prefix}_logps_T{t}_eos", b, t, t, hq, hkv, d, True, None,
                        full, 43)]
    bwd_rows = [bwd_case(torch, f"{prefix}_update_T{t}_eos", b, t, t, hq, hkv, d, True, 0,
                         full, 44)]
    return rows, bwd_rows


def phase_grpo(torch, card, sft_final):
    """GRPO through the port's trainer and CLI (module docstring, phase 8)."""
    import torch.nn.functional as F
    from torch.profiler import record_function
    from bioreason_tpu_torch.cli import reason
    from bioreason_tpu_torch.models import qwen3
    from bioreason_tpu_torch.ops.sampling import sample_logits
    from bioreason_tpu_torch.train import grpo as grpo_mod
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import get_reward_funcs
    t_phase = time.perf_counter()
    cfg, gcfg, proc, items = grpo_setup()
    n = len(items)
    trainer = GRPOTrainer(cfg, gcfg, proc,
                          get_reward_funcs(["xmlcount", "correctness"]) + [acgt_share_reward])
    b_leaves = {k: p.detach().clone() for k, p in trainer.trainable_state().items()
                if k.endswith("lora_b")}
    # per step: the rollout's encoder and prefill, the ref pass's encoder and
    # decoder, the update's encoder and its decoder twice (remat), one
    # backward per decoder layer; decode steps (Tq = 1) take the plain
    # grouped attention
    per_step = {"flash_fwd": 3 * ENCODER_LAYERS + 4 * DECODER_LAYERS,
                "flash_bwd": DECODER_LAYERS}
    log(f"grpo: trainer built in {time.perf_counter() - t_phase:.1f} s")
    t_sub = time.perf_counter()
    history = [trainer.step(items)]                      # warm-up
    torch.cuda.synchronize()
    log(f"grpo: warm-up step {time.perf_counter() - t_sub:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    trainer.timers = {}
    steps = 2                                            # cut from 3 for the script's time
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    t0 = time.perf_counter()
    history += [trainer.step(items) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    tm = trainer.timers
    trainer.timers = None
    stats = trainer.engine.last_stats
    log(f"grpo [{card}]: {GRPO_PROMPTS} prompts x G={GRPO_G}, P={stats['prompt_len']}, "
        f"{GRPO_NEW} new tokens, LoRA r32/a64, beta 0.04, remat full: "
        f"{n * steps / dt:.3f} completions/s, {dt / steps * 1e3:.1f} ms per step over {steps} "
        f"steps; seconds per phase {', '.join(f'{k} {tm[k]:.3f}' for k in ('prep', 'rollout', 'logps_dispatch', 'rewards', 'update'))} "
        f"({tm['steps']} steps); torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"grpo: launches {got} ({', '.join(f'{k} {v / steps:g}' for k, v in got.items())} "
        f"per step); last rollout decode {stats['steps'] - 1} steps in "
        f"{stats['decode_s'] * 1e3:.1f} ms, prefill {stats['prefill_s'] * 1e3:.1f} ms; "
        f"nonfinite_rows {[m['nonfinite_rows'] for m in history]}")
    log("grpo: per step " + "; ".join(
        f"loss {m['loss']:.5g} kl {m['kl']:.4g} clip {m['clip_ratio']:.3g} grad_norm "
        f"{m['grad_norm']:.4g} reward {m['reward']:.3g} length {m['completion_length']:.1f}"
        for m in history))
    if any(not math.isfinite(m[k]) for m in history for k in ("loss", "kl", "reward")):
        fail(f"non-finite GRPO loss, kl or reward: {history}")
    want = {k: steps * per_step.get(k, 0) for k in got}
    if got != want:
        fail(f"GRPO launched {got} in {steps} steps, expected {want}")
    state = trainer.trainable_state()
    still = [k for k, b0 in b_leaves.items() if torch.equal(state[k].detach(), b0)]
    log(f"grpo: {len(b_leaves) - len(still)} of {len(b_leaves)} LoRA B leaves moved")
    if still:
        fail(f"GRPO LoRA B leaves did not move: {still[:4]}")

    # one step profiled, with the device time of its parts
    t_sub = time.perf_counter()
    ranges = {"rollout": (trainer.engine, "generate"),
              "update": (trainer, "_update"),
              "grouped_decode_attention": (qwen3, "_grouped_decode_attention")}
    saved = {name: getattr(obj, attr) for name, (obj, attr) in ranges.items()}
    real_logps = grpo_mod.per_token_logps

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    def logps(model, *a, **kw):
        with record_function("ref_logps" if model is trainer.ref_model else "policy_logps"):
            return real_logps(model, *a, **kw)
    try:
        for name, (obj, attr) in ranges.items():
            setattr(obj, attr, labelled(name, saved[name]))
        grpo_mod.per_token_logps = logps
        profile_step(torch, card, "grpo step", lambda: trainer.step(items),
                     ("flash_fwd", "flash_bwd"), (*ranges, "ref_logps", "policy_logps"))
    finally:
        for name, (obj, attr) in ranges.items():
            setattr(obj, attr, saved[name])
        grpo_mod.per_token_logps = real_logps
    log(f"grpo: profiled step and its reading took {time.perf_counter() - t_sub:.1f} s")
    t_sub = time.perf_counter()

    # greedy grouped rollouts: identical within each group
    out, _ = trainer._prepare_prompts(items[::GRPO_G])
    ids, _ = trainer.engine.generate(trainer.model, out.input_ids, out.attention_mask,
                                     out.dna_input_ids, out.dna_attention_mask, greedy=True,
                                     max_new_tokens=16, group_size=GRPO_G)
    groups = ids.reshape(GRPO_PROMPTS, GRPO_G, -1)
    if not (groups == groups[:, :1]).all():
        fail("greedy grouped rollouts differ within a group")
    log(f"grpo: greedy grouped rollouts [{ids.shape[0]}, {ids.shape[1]}] identical within "
        f"each of {GRPO_PROMPTS} groups ({time.perf_counter() - t_sub:.1f} s)")
    t_sub = time.perf_counter()

    # one update loss + gradient through the kernels against the plain route
    buf = trainer._buffers[0]

    def loss_and_grad(c):
        trainer.fusion_cfg = c
        try:
            loss, kl, _ = trainer._loss(buf["batch"], buf["completion_len"])
            grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        finally:
            trainer.fusion_cfg = cfg
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).float().flatten()
                          for p, g in zip(trainer.params, grads)])
        return float(loss.detach()), float(kl.detach()), flat
    reset_counts()
    lk, kk, gk = loss_and_grad(cfg)
    kernel_counts = counts()
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla"),
        encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"))
    reset_counts()
    lp, kp, gp = loss_and_grad(plain)
    if any(counts().values()) or not kernel_counts["flash_bwd"]:
        fail(f"the routes launched {kernel_counts} (kernel) and {counts()} (plain)")
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    log(f"grpo: kernel vs plain route, one update loss + gradient on the last rollout buffer: "
        f"loss {lk:.6g} vs {lp:.6g}, kl {kk:.6g} vs {kp:.6g}, cosine of the {gk.numel()} "
        f"trainable gradients {cos:.6f}, norms {float(gk.norm()):.4g} vs "
        f"{float(gp.norm()):.4g} ({time.perf_counter() - t_sub:.1f} s)")
    if not (math.isfinite(lk) and math.isfinite(lp)) or cos < 0.99:
        fail(f"kernel and plain routes disagree in the GRPO update (cosine {cos:.4f})")
    del gk, gp

    # the sampler on non-finite rows, on the card
    bad = torch.randn((4, cfg.decoder.vocab_size), device="cuda")
    bad[1] = float("nan")
    bad[2] = float("-inf")
    ids_bad = sample_logits(bad, 0.6, 20, 0.95,
                            generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    if ids_bad[1:3].tolist() != [0, 0] or not bool(((ids_bad >= 0) & (
            ids_bad < cfg.decoder.vocab_size)).all()):
        fail(f"sample_logits on a NaN and an all -inf row gave {ids_bad.tolist()}")
    log(f"grpo: sample_logits on the card, rows finite / NaN / all -inf / finite: "
        f"{ids_bad.tolist()}")
    t_sub = time.perf_counter()
    rows, bwd_rows = grpo_kernel_cases(torch, trainer, items)
    log(f"grpo: kernels at the step's shapes checked in {time.perf_counter() - t_sub:.1f} s")
    secs_trainer = time.perf_counter() - t_phase
    del trainer, buf
    torch.cuda.empty_cache()

    # the reason CLI from phase 6's sft_final
    run_dir = os.path.dirname(sft_final)
    reset_counts()
    t0 = time.perf_counter()
    cli = reason.main(["--sft_checkpoint", sft_final, "--seed", "0", "--max_steps", "2",
                       "--num_generations", str(GRPO_G), "--batch_size",
                       str(GRPO_PROMPTS * GRPO_G), "--max_completion_length", str(GRPO_NEW),
                       "--max_length_dna", "128", "--checkpoint_dir", run_dir,
                       "--log_dir", os.path.join(run_dir, "logs")])
    secs = time.perf_counter() - t0
    cli_counts = counts()
    hist = cli.metrics_history
    log(f"grpo (reason cli) [{card}]: 2 steps from {os.path.basename(sft_final)} in "
        f"{secs:.1f} s (model rebuild included): losses {[round(m['loss'], 6) for m in hist]}, "
        f"kl {[round(m['kl'], 6) for m in hist]}, rewards {[m['reward'] for m in hist]}; "
        f"launches {cli_counts}")
    if len(hist) != 2 or not all(math.isfinite(m["loss"]) and math.isfinite(m["reward"])
                                 for m in hist):
        fail(f"reason.main did not run 2 finite steps: {hist}")
    if not os.path.isfile(os.path.join(run_dir, "grpo_final", "state.pt")):
        fail("reason.main wrote no grpo_final")
    del cli
    torch.cuda.empty_cache()
    log(f"grpo: phase done in {time.perf_counter() - t_phase:.1f} s (trainer part "
        f"{secs_trainer:.1f} s)")
    return got, rows, bwd_rows, dt / steps * 1e3


# -- phase 9 -----------------------------------------------------------------

EVO2_BLOCKS, EVO2_ATTN = 25, (6, 13, 20)     # Evo2-1B: attention in 3 of 25 blocks
EVO2_BP = 2048                               # 2 x 2 kb per KEGG item, one byte token per bp
# the committed fixtures (tests/assets) and their goldens' tolerance: 2e-5
# for the 4-block tower; the 25-block one's goldens carry fp32 rounding of
# their own beyond 2e-5 (an fp64 evaluation misses them by up to 3.50e-5,
# tests/test_torch_evo2.py), so 1e-4 there
EVO2_FIXTURES = (("evo2_tiny", 1, (2, 12), ((None, "evo2_tiny_out"), (2, "evo2_tiny_tap")),
                  2e-5),
                 ("evo2_1b_depth_tiny", 5, (2, 24),
                  ((None, "evo2_1b_depth_out"), (20, "evo2_1b_depth_tap20")), 1e-4))


def evo2_served_inputs(n: int = 8):
    """The 8-request batch phase 9 serves, as `prepare_batch` hands it to
    the engine: KEGG-shaped items of 2 x 2048 bp, byte-tokenized."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.serve import build_config, prepare_batch
    items = synthetic_kegg_items(n=n, seq_len=EVO2_BP, seed=0)
    cfg, processor = build_config("qwen3-0.6b", "evo2-1b", max_length_dna=EVO2_BP)
    return items, prepare_batch(processor, cfg, items)


def phase_evo2_goldens(torch):
    """The committed vortex fixtures through the port's importer on the
    card, fp32, the plain attention of their own configs: held to their
    goldens with cuDNN's TF32 off (this script's setting) and on (PyTorch's
    default), so the depthwise convolutions' precision is measured."""
    from bioreason_tpu_torch.models.evo2 import hyena_forward
    from bioreason_tpu_torch.utils.pretrained import load_pretrained_evo2
    assets = os.path.join(REPO, "tests", "assets")
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    worst = 0.0
    for name, seed, shape, outs, tol in EVO2_FIXTURES:
        tmp = tempfile.mkdtemp(prefix="smoke_evo2_", dir=build_dir)
        try:
            shutil.copy(os.path.join(assets, f"{name}.pt"), tmp)
            cfg, tower = load_pretrained_evo2(tmp, device="cuda", dtype="float32",
                                              attention_impl="xla", remat=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ids = torch.as_tensor(np.random.default_rng(seed).integers(0, 32, shape),
                              dtype=torch.int32, device="cuda")
        for tap, golden in outs:
            want = np.load(os.path.join(assets, f"{golden}.npy"))
            errs = {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                try:
                    with torch.no_grad():
                        got = hyena_forward(tower, cfg, ids, tap_layer=tap).cpu().numpy()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                err = np.abs(got - want)
                errs[tf32] = (float(err.max()), float((err / (tol + tol * np.abs(want))).max()))
            log(f"evo2 goldens: {name} {golden} on the card, fp32: max abs err {errs[False][0]:.3g} "
                f"({errs[False][1]:.3f} of the tolerance {tol:g} abs + rel) with cuDNN TF32 off, "
                f"{errs[True][0]:.3g} ({errs[True][1]:.3f}) with it on")
            if max(errs[False][1], errs[True][1]) > 1.0:
                fail(f"the {name} fixture misses its golden {golden} on the card: {errs}")
            worst = max(worst, errs[False][0], errs[True][0])
    return worst


def phase_evo2_serve(torch, card, max_new):
    """Evo2-1B + Qwen3-0.6B served at full width (module docstring, phase 9)."""
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.evo2 import hyena_forward
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.serve import build_server, prepare_batch

    t_phase = time.perf_counter()
    server = build_server("qwen3-0.6b", "evo2-1b", max_length_dna=EVO2_BP, seed=0,
                          max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                          greedy_default=True)
    cfg = server.cfg
    hy, dec = cfg.hyena, cfg.decoder
    attn_blocks = tuple(i for i in range(hy.num_layers) if hy.flavor(i) == "attn")
    if (cfg.encoder_kind, hy.num_layers, hy.hidden_size, hy.num_heads, hy.head_dim,
            hy.intermediate_size, attn_blocks) != ("evo2", EVO2_BLOCKS, 1920, 15, 128, 5120,
                                                   EVO2_ATTN):
        fail(f"the DNA tower is not Evo2-1B: {cfg.encoder_kind} {hy}")
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.vocab_size) != (
            DECODER_LAYERS, 1024, 16, 8, 151936):
        fail(f"decoder is not at Qwen3-0.6B width: {dec}")
    n_tower = sum(p.numel() for p in server.model.encoder.parameters())
    n_all = sum(p.numel() for p in server.model.parameters())
    items, (ids, mask, dna, dmask) = evo2_served_inputs()
    flavors = "".join(hy.flavor(i)[0] for i in range(hy.num_layers))
    log(f"evo2 serve: model of {n_all / 1e6:.1f} M parameters ({n_tower / 1e6:.1f} M in the "
        f"Evo2 tower, flavors {flavors}), seed 0, built in {time.perf_counter() - t_phase:.2f} s; the served batch: B="
        f"{ids.shape[0]} P={ids.shape[1]} text tokens, DNA {list(dna.shape)} "
        f"({int(dmask.sum())} valid)")

    # the kernel route against the plain route on one request at full width
    one = [torch.as_tensor(a, device="cuda")
           for a in prepare_batch(server.processor, cfg, items[:1])]
    plain_cfg = dataclasses.replace(cfg, hyena=dataclasses.replace(hy, attention_impl="xla"),
                                    decoder=dataclasses.replace(dec, attention_impl="xla"))
    eos = server.processor.text_tokenizer.eos_token_id
    before = fa.flash_attention.launches
    k_logits = server.engine.prefill(server.model, *one, max_new)[0]
    if fa.flash_attention.launches - before != len(EVO2_ATTN) + DECODER_LAYERS:
        fail("the kernel route did not launch flash_fwd once per tower attention block and "
             "prefill layer")
    p_logits = GenerationEngine(plain_cfg, eos).prefill(server.model, *one, max_new)[0]
    if not (bool(torch.isfinite(k_logits).all()) and bool(torch.isfinite(p_logits).all())):
        fail("non-finite Evo2 prefill logits")
    cos = float(torch.nn.functional.cosine_similarity(k_logits, p_logits, dim=-1).min())
    log(f"evo2 serve: kernel vs plain route, last-column prefill logits of one request "
        f"(P={one[0].shape[1]}): min cosine {cos:.6f}, max abs diff "
        f"{float((k_logits - p_logits).abs().max()):.4g}, same argmax "
        f"{bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())}")
    if cos < 0.99:
        fail(f"kernel and plain routes disagree on the Evo2 path (cosine {cos:.4f})")
    del k_logits, p_logits

    server.start()
    calls_out, restore = record_engine_calls(server)

    # --- the main path: counts from 0 just before, read just after ---------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls0 = server.engine_calls
    first = burst(server, items, max_new)
    n_first = len(calls_out)
    second = burst(server, items, max_new)
    got = counts()
    calls = server.engine_calls - calls0
    peak = torch.cuda.max_memory_allocated()
    server.stop()
    restore()
    # -----------------------------------------------------------------------

    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    if len(answered) != 16:
        fail(f"not every Evo2 request was answered: {first} {second}")
    rows = [completion_rows(calls_out[:n_first]), completion_rows(calls_out[n_first:])]
    if len(rows[0]) != 8 or rows[0] != rows[1] or first != second:
        fail("greedy repeats of the same 8 Evo2 requests differ")
    per_call = len(EVO2_ATTN) + DECODER_LAYERS
    if got["flash_fwd"] != per_call * calls or any(v for k, v in got.items() if k != "flash_fwd"):
        fail(f"the Evo2 server launched {got} in {calls} engine calls, expected "
             f"{per_call} flash_fwd per call ({len(EVO2_ATTN)} tower attention blocks + "
             f"{DECODER_LAYERS} prefill layers)")
    log(f"evo2 serve: 16 requests answered in {calls} engine calls ({n_first} for the first "
        f"8); flash_fwd launches {got['flash_fwd']} = {got['flash_fwd'] // max(calls, 1)} per "
        f"call; greedy repeats identical")
    for name, (_, st) in (("first 8", calls_out[n_first - 1]), ("same 8 again", calls_out[-1])):
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"evo2 serve [{card}] {name}: B={st['batch']} P={st['prompt_len']}: prefill "
            f"(tower + splice + prefill + first token) {st['prefill_s'] * 1e3:.1f} ms; decode "
            f"{tps:.1f} tokens/s over {st['steps'] - 1} steps "
            f"({st['decode_s'] / max(st['steps'] - 1, 1) * 1e3:.2f} ms per step)")
    log(f"evo2 serve [{card}]: torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")

    # one profiled prefill, its device time split by part
    args = [torch.as_tensor(a, device="cuda") for a in (ids, mask, dna, dmask)]
    evo2_profile(torch, card, "evo2 prefill",
                 lambda: server.engine.prefill(server.model, *args, max_new),
                 tower_attention_first=len(EVO2_ATTN))

    # the frozen-dtype question (ROADMAP 3): the tower's output with its
    # filter leaves stored in bf16, as a frozen SFT tower stores them,
    # against fp32 storage, same seed, on the served DNA
    tower = server.model.encoder
    d_ids, d_mask = args[2], args[3]
    with torch.no_grad():
        ref = hyena_forward(tower, hy, d_ids, d_mask)
        saved = {n: p.detach().clone() for n, p in tower.named_parameters()
                 if ".hyena." in n and p.dtype == torch.float32 and p.dim() >= 2}
        for which in ("poles", "all"):
            for n, p in tower.named_parameters():
                if n in saved and (which == "all" or n.endswith("filter.poles")):
                    p.copy_(saved[n].to(torch.bfloat16))
            out = hyena_forward(tower, hy, d_ids, d_mask)
            v = d_mask.bool()
            diff = (out.float() - ref.float())[v]
            rel = float(diff.norm() / ref.float()[v].norm())
            cosr = float(torch.nn.functional.cosine_similarity(out.float()[v], ref.float()[v],
                                                               dim=-1).min())
            log(f"evo2 frozen storage [{card}]: tower output [{list(ref.shape)}] with "
                f"{'the li poles' if which == 'poles' else 'every filter leaf of ndim >= 2'} "
                f"stored in bf16 against fp32: max abs diff {float(diff.abs().max()):.4g} "
                f"(max |out| {float(ref.float()[v].abs().max()):.4g}), relative norm "
                f"{rel:.4g}, min row cosine {cosr:.6f}")
            for n, p in tower.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
    del saved, ref
    log(f"evo2 serve: phase done in {time.perf_counter() - t_phase:.1f} s")
    return got, (ids, mask, dna, dmask)


EVO2_PARTS = ("hyena_conv", "hyena_filters", "evo2_tower")


def evo2_profile(torch, card, label, step, tower_attention_first=0):
    """`profile_step` over `step` with the tower and its hyena parts in
    `record_function` ranges; prints the device time of the tower and of
    the rest, each split into hyena convolutions / FFT (with their fp32
    casts and copies), filter materialization, attention, GEMMs and the
    rest (elementwise and copy kernels). A flash kernel, launched from its
    C entry, may link to no host op: with `tower_attention_first` = n, the
    first n flash kernels on the device are the tower's (a prefill runs the
    tower before the decoder). Kernels of a backward run outside the ranges
    (autograd launches them after the forward), so in a training step the
    tower's parts count its forward and none of its backward."""
    from torch.profiler import record_function
    from bioreason_tpu_torch.models import evo2 as evo2_mod
    from bioreason_tpu_torch.models import fusion as fusion_mod
    targets = {"hyena_conv": [(evo2_mod, "depthwise_causal_conv"), (evo2_mod, "fft_causal_conv")],
               "hyena_filters": [(evo2_mod, "materialize_mr_filter"),
                                 (evo2_mod, "materialize_li_filter")],
               "evo2_tower": [(fusion_mod, "hyena_forward")]}
    saved = {(m, a): getattr(m, a) for pairs in targets.values() for m, a in pairs}

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    try:
        for name, pairs in targets.items():
            for m, a in pairs:
                setattr(m, a, labelled(name, saved[(m, a)]))
        busy, wall, _, kernels = profile_step(torch, card, label, step,
                                              ("flash_fwd", "flash_bwd"), EVO2_PARTS)
    finally:
        for (m, a), fn in saved.items():
            setattr(m, a, fn)
    kinds = ("hyena convolutions / FFT", "hyena filter materialization", "attention", "GEMMs",
             "rest")
    split = {part: dict.fromkeys(kinds, 0.0) for part in ("tower", "outside the tower")}
    gemm = ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitk")
    flash = sorted((start, k) for k, (name, _, _, start) in enumerate(kernels)
                   if "flash_" in name)
    tower_flash = {k for _, k in flash[:tower_attention_first]}
    for k, (name, dur, rs, _) in enumerate(kernels):
        low = name.lower()
        part = "tower" if "evo2_tower" in rs or k in tower_flash else "outside the tower"
        if "hyena_conv" in rs:
            kind = "hyena convolutions / FFT"
        elif "hyena_filters" in rs:
            kind = "hyena filter materialization"
        elif "flash_" in low:
            kind = "attention"
        elif any(g in low for g in gemm):
            kind = "GEMMs"
        else:
            kind = "rest"
        split[part][kind] += dur / 1e6
    for part, row in split.items():
        total = sum(row.values())
        log(f"profile [{card}] {label} split, {part}: {total:.3f} device ms "
            f"({100 * total / max(busy, 1e-9):.1f}% of busy {busy:.2f} ms): "
            + ", ".join(f"{k} {v:.3f} ({100 * v / max(busy, 1e-9):.1f}%)"
                        for k, v in row.items()))
    return split


# -- phase 10 ----------------------------------------------------------------

def evo2_kernel_cases(torch, served):
    """flash_fwd and flash_bwd at the Evo2 path's own shapes and masks: the
    tower's attention [16, 2048, 15/15, 128] causal as served (2 kb
    sequences: all valid) and with left pads of mixed lengths, the decoder
    prefill of the served batch (causal, a cache of P +
    64 slots, its left pads), and the finetune step's tower backward
    [4, 2048, 15/15, 128] causal with mixed left pads."""
    g = torch.Generator(device="cuda").manual_seed(51)
    ids, mask, dna, _ = served
    b, p = ids.shape
    cmask = torch.as_tensor(np.pad(mask, ((0, 0), (0, 64))), device="cuda")
    rows = [kernel_case(torch, "evo2_tower_T2048", 16, EVO2_BP, EVO2_BP, 15, 15, 128, True, 0,
                        torch.as_tensor(served[3], device="cuda"), 50),
            kernel_case(torch, "evo2_tower_T2048_leftpad", 16, EVO2_BP, EVO2_BP, 15, 15, 128,
                        True, 0, left_padded(torch, 16, EVO2_BP, 0, 1500, g), 51),
            kernel_case(torch, f"evo2_prefill_P{p}", b, p, p + 64, 16, 8, 128, True, 0,
                        cmask, 52)]
    bwd_rows = [bwd_case(torch, "evo2_tower_T2048_leftpad_bwd", 4, EVO2_BP, EVO2_BP, 15, 15,
                         128, True, 0, left_padded(torch, 4, EVO2_BP, 0, 1500, g), 53)]
    return rows, bwd_rows


def evo2_train_items():
    """16 KEGG-shaped items of 2 x 2048 bp for the Evo2 SFT phase."""
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    return synthetic_kegg_items(n=16, seq_len=EVO2_BP, seed=1)


def phase_evo2_train(torch, card):
    """Evo2 SFT at full width through the CLI, frozen and finetuned (module
    docstring, phase 10)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli import train_sft
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer
    from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.data.kegg import format_kegg_for_dna_llm
    from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion
    t_phase = time.perf_counter()
    n_attn = len(EVO2_ATTN)
    # the decoder keeps remat on (its preset): each of its layers runs its
    # forward twice a step; the frozen tower runs without autograd (no
    # remat), the trained one with remat (its preset): forward twice, and
    # one backward per attention block
    per_step = {"frozen": {"flash_fwd": n_attn + 2 * DECODER_LAYERS,
                           "flash_bwd": DECODER_LAYERS},
                "finetune": {"flash_fwd": 2 * n_attn + 2 * DECODER_LAYERS,
                             "flash_bwd": n_attn + DECODER_LAYERS}}
    items = evo2_train_items()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_evo2_", dir=build_dir)
    steps = 3
    out = {}
    try:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "kegg_2kb.jsonl"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(json.dumps(x) for x in items))
        for mode in ("frozen", "finetune"):
            argv = ["--decoder", "qwen3-0.6b", "--encoder", "evo2-1b", "--max_steps", str(steps),
                    "--seed", "0",
                    "--checkpoint_dir", os.path.join(tmp, mode), "--max_length_dna",
                    str(EVO2_BP), "--truncate_dna_per_side", "0", "--data_dir", data_dir]
            if mode == "finetune":
                argv.append("--dna_model_finetune")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # --- the main path: counts from 0 just before, read just after ---
            reset_counts()
            t0 = time.perf_counter()
            trainer = train_sft.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counts()
            # -----------------------------------------------------------------
            peak = torch.cuda.max_memory_allocated()
            losses = [m["loss"] for m in trainer.history]
            want = {k: steps * per_step[mode].get(k, 0) for k in got}
            log(f"evo2 train (cli, {mode}) [{card}]: {steps} steps in {secs:.1f} s (model, data "
                f"and checkpoint included), losses {[round(x, 4) for x in losses]}, step ms "
                f"{[round(m['step_time'] * 1e3, 1) for m in trainer.history]}, "
                f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; launches {got}")
            if len(losses) != steps or not all(math.isfinite(x) for x in losses):
                fail(f"train_sft --encoder evo2-1b ({mode}) did not run {steps} finite steps")
            if got != want:
                fail(f"train_sft --encoder evo2-1b ({mode}) launched {got}, expected {want}")
            tower = trainer.model.encoder
            poles = tower.blocks[2].hyena.filter.poles
            if poles.dtype != (torch.bfloat16 if mode == "frozen" else torch.float32):
                fail(f"{mode}: the li poles are stored in {poles.dtype}")
            out[mode] = {"launches": got, "step_ms": [m["step_time"] * 1e3
                                                      for m in trainer.history],
                         "peak_gib": peak / 2**30}
            if mode == "frozen":
                del trainer, tower, poles
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # every leaf of the trained tower moved from its seeded init
    init = init_fusion(trainer.fusion_cfg, seed=0, device="cuda")
    state = trainer.trainable_state()
    enc = list(init.encoder.named_parameters())
    still = [n for n, p in enc if torch.equal(state[f"encoder.{n}"].detach(), p.float())]
    log(f"evo2 train (cli, finetune): {len(enc) - len(still)} of {len(enc)} tower leaves "
        f"moved")
    if still:
        fail(f"Evo2 tower leaves did not move: {still[:4]}")
    del init, enc, state

    # the finetune trainer on one batch: timed steps, memory, profile, cosine
    proc = BioProcessor(ByteTextTokenizer(), CharDNATokenizer())
    batch = sft_collate([format_kegg_for_dna_llm(x) for x in items[:2]], proc,
                        max_length_text=512, max_length_dna=EVO2_BP, bucket=128)
    b, t = np.asarray(batch["input_ids"]).shape
    s_, t_dna = np.asarray(batch["dna_input_ids"]).shape
    n_train = sum(p.numel() for p in trainer.params)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts from 0 just before, read just after ---------
    reset_counts()
    step_ms = []
    for _ in range(steps):
        ts = time.perf_counter()
        trainer.train_step(batch)                # ends in a host sync (loss, norm)
        step_ms.append((time.perf_counter() - ts) * 1e3)
    got = counts()
    # -----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    log(f"evo2 train (trainer, finetune) [{card}]: B={b} T={t}, tower {s_} x {t_dna} byte "
        f"tokens, {n_train / 1e6:.1f} M trainable parameters (LoRA r32 + projection + the "
        f"tower, fp32 masters), remat on: step ms {[round(x, 1) for x in step_ms]} "
        f"({b * steps / (sum(step_ms) / 1e3):.3f} examples/s); held between steps "
        f"{held / 2**30:.2f} GiB (weights, masters, AdamW moments), "
        f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; launches {got}")
    if got != {k: steps * per_step["finetune"].get(k, 0) for k in got}:
        fail(f"the Evo2 finetune trainer launched {got} in {steps} steps")
    out["trainer"] = {"step_ms": step_ms, "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                      "launches": got}
    evo2_profile(torch, card, "evo2 finetune step", lambda: trainer.train_step(batch))

    # one loss + gradient through the kernels against the plain route
    db = trainer._device_batch(batch)
    cfg = trainer.fusion_cfg

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"], train_encoder=True)
        grads = torch.autograd.grad(loss, trainer.params)
        return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk, gk = loss_and_grad(cfg)
    log(f"evo2 train: forward + backward alone (the gradients returned, no optimizer) "
        f"peaks at {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla"),
        hyena=dataclasses.replace(cfg.hyena, attention_impl="xla"))
    reset_counts()
    lp, gp = loss_and_grad(plain)
    if any(counts().values()):
        fail(f"the plain route launched kernels: {counts()}")
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    # the tower's parameters come first in the trainable list
    n_tower = sum(p.numel() for n, p in zip(trainer.names, trainer.params)
                  if n.startswith("encoder."))
    cos_tower = float(F.cosine_similarity(gk[:n_tower], gp[:n_tower], dim=0))
    log(f"evo2 train: kernel vs plain route, one loss + gradient (tower trained): loss "
        f"{lk:.6f} vs {lp:.6f} (diff {abs(lk - lp):.3g}), cosine of the {gk.numel()} trainable "
        f"gradients {cos:.6f}, of the tower's {n_tower} {cos_tower:.6f}; norms "
        f"{float(gk.norm()):.4g} vs {float(gp.norm()):.4g}")
    if not (math.isfinite(lk) and math.isfinite(lp)) or min(cos, cos_tower) < 0.99:
        fail(f"kernel and plain routes disagree in Evo2 training (cosine {cos:.4f})")
    del gk, gp, trainer
    torch.cuda.empty_cache()
    log(f"evo2 train: phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 11 ----------------------------------------------------------------

# the published configurations (Qwen3-0.6B config.json; NT-v2-500M's ESM
# config), written as HF directories with weights drawn from a seed
QWEN3_0_6B_HF = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
                 "vocab_size": 151936, "hidden_size": 1024, "intermediate_size": 3072,
                 "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8,
                 "head_dim": 128, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
                 "tie_word_embeddings": True, "torch_dtype": "bfloat16"}
NT_V2_500M_HF = {"architectures": ["EsmForMaskedLM"], "model_type": "esm", "vocab_size": 4107,
                 "hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 29,
                 "num_attention_heads": 16, "position_embedding_type": "rotary",
                 "layer_norm_eps": 1e-12, "add_bias_fnn": False, "token_dropout": False,
                 "mask_token_id": 2, "pad_token_id": 1, "max_position_embeddings": 2050}
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN_BPE_TOKENS = 151643                   # ids 0..151642; the added tokens follow
PRETRAINED_BP = 2048                       # 2 x 2 kb per variant-effect item
# serve --checkpoint against the SFT model in memory with LoRA unmerged: the
# merge folds the fp32 delta into bf16 weights (one rounding of W + delta
# where the unmerged path adds x @ A @ B in bf16), so the two prefills
# differ by bf16 rounding: min cosine and max |diff| / max |logit|
MERGED_COS, MERGED_REL = 0.999, 2e-2


def write_qwen_tokenizer(path):
    """A Qwen2-style byte-level `tokenizer.json` with Qwen's Split regex,
    NFC, 151,643 BPE tokens (the byte alphabet, every pair of it, then
    pairs with a third byte; one merge per token) and the added tokens at
    Qwen3's ids: <|endoftext|> 151643, <|im_start|> 151644, <|im_end|>
    151645, placeholders to 151666, <think> / </think> 151667-151668, so
    the DNA tokens land at 151669-151671 as they do with the real file."""
    from bioreason_tpu_torch.data.bpe import byte_encoder
    alphabet = sorted(byte_encoder().values())
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for a in alphabet:
        for b in alphabet:
            vocab[a + b] = len(vocab)
            merges.append([a, b])
    pairs = list(merges)
    for a, b in pairs:
        for c in alphabet:
            if len(vocab) == QWEN_BPE_TOKENS:
                break
            vocab[a + b + c] = len(vocab)
            merges.append([a + b, c])
        if len(vocab) == QWEN_BPE_TOKENS:
            break
    added = (["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
             + [f"<|placeholder_{i}|>" for i in range(21)] + ["<think>", "</think>"])
    added_tokens = [{"id": QWEN_BPE_TOKENS + i, "content": t, "single_word": False,
                     "lstrip": False, "rstrip": False, "normalized": False,
                     "special": t not in ("<think>", "</think>")} for i, t in enumerate(added)]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added_tokens,
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                 "use_regex": False}]},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                        "use_regex": False},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}, f)


def pretrained_states(torch, seed=0):
    """HF-named weights drawn on the card from `seed`: Qwen3-0.6B in bf16
    (dense N(0, 1/in), embedding N(0, 0.02^2), norm scales 1 + N(0, 0.1^2):
    non-unit), NT-v2-500M in fp32 (the fused gated `intermediate.dense`
    [8192, 1024] without bias, q/k/v/o biases and layer-norm shifts
    N(0, 0.02^2): non-zero, scales non-unit)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, std, dtype, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)
    q, n = QWEN3_0_6B_HF, NT_V2_500M_HF
    bf, hd = torch.bfloat16, q["head_dim"]
    h, hq, hkv = q["hidden_size"], q["num_attention_heads"] * hd, q["num_key_value_heads"] * hd
    qwen = {"model.embed_tokens.weight": rand((q["vocab_size"], h), 0.02, bf),
            "model.norm.weight": rand((h,), 0.1, bf, 1.0)}
    for i in range(q["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, (o, k) in (("self_attn.q_proj", (hq, h)), ("self_attn.k_proj", (hkv, h)),
                             ("self_attn.v_proj", (hkv, h)), ("self_attn.o_proj", (h, hq)),
                             ("mlp.gate_proj", (q["intermediate_size"], h)),
                             ("mlp.up_proj", (q["intermediate_size"], h)),
                             ("mlp.down_proj", (h, q["intermediate_size"]))):
            qwen[p + name + ".weight"] = rand((o, k), k ** -0.5, bf)
        for name, d in (("self_attn.q_norm", hd), ("self_attn.k_norm", hd),
                        ("input_layernorm", h), ("post_attention_layernorm", h)):
            qwen[p + name + ".weight"] = rand((d,), 0.1, bf, 1.0)
    f32, d, inter = torch.float32, n["hidden_size"], n["intermediate_size"]
    nt = {"esm.embeddings.word_embeddings.weight": rand((n["vocab_size"], d), 0.02, f32),
          "esm.encoder.emb_layer_norm_after.weight": rand((d,), 0.1, f32, 1.0),
          "esm.encoder.emb_layer_norm_after.bias": rand((d,), 0.02, f32)}
    for i in range(n["num_hidden_layers"]):
        p = f"esm.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            nt[p + name + ".weight"] = rand((d, d), d ** -0.5, f32)
            nt[p + name + ".bias"] = rand((d,), 0.02, f32)
        for name in ("attention.LayerNorm", "LayerNorm"):
            nt[p + name + ".weight"] = rand((d,), 0.1, f32, 1.0)
            nt[p + name + ".bias"] = rand((d,), 0.02, f32)
        nt[p + "intermediate.dense.weight"] = rand((2 * inter, d), d ** -0.5, f32)
        nt[p + "output.dense.weight"] = rand((d, inter), inter ** -0.5, f32)
        ehd = d // n["num_attention_heads"]
        nt[p + "attention.self.rotary_embeddings.inv_freq"] = 1.0 / (
            10000.0 ** (torch.arange(0, ehd, 2, device="cuda", dtype=f32) / ehd))
    return qwen, nt


def variant_items(n, bp, seed=0):
    """Coding variant-effect records as data/variant_effect.py reads them."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ref = "".join(rng.choice(list("ACGT"), bp))
        pos = int(rng.integers(0, bp))
        alt = "ACGT"[("ACGT".index(ref[pos]) + 1 + int(rng.integers(0, 3))) % 4]
        out.append({"question": f"Variant at position {pos} of this coding sequence: is it "
                                f"benign or pathogenic?",
                    "answer": "Pathogenic; ClinVar" if k % 2 else "Benign",
                    "reference_sequence": ref,
                    "variant_sequence": ref[:pos] + alt + ref[pos + 1:]})
    return out


def phase_pretrained(torch, card, max_new):
    """The port on HF-layout checkpoints at full width (module docstring,
    phase 11)."""
    import copy

    from bioreason_tpu_torch.cli import reason, train_sft
    from bioreason_tpu_torch.data import BioProcessor
    from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.serve import build_server, prepare_batch
    from bioreason_tpu_torch.train import grpo as grpo_mod
    from bioreason_tpu_torch.train.lora import merge_lora
    from bioreason_tpu_torch.utils import pretrained as P
    from bioreason_tpu_torch.utils.hf_import import export_decoder_to_hf, export_encoder_to_hf
    from bioreason_tpu_torch.utils.ref_ckpt import export_reference_sft
    from bioreason_tpu_torch.utils.safetensors_io import save_file
    t_phase = time.perf_counter()
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_pretrained_", dir=build_dir)
    out = {}
    try:
        qwen_dir, nt_dir = os.path.join(tmp, "qwen3-0.6b"), os.path.join(tmp, "nt-v2-500m")
        os.makedirs(qwen_dir)
        os.makedirs(nt_dir)
        # (1) the two directories, written by the port's own writer
        t0 = time.perf_counter()
        write_qwen_tokenizer(qwen_dir)
        t_tok = time.perf_counter() - t0
        qwen, nt = pretrained_states(torch)
        written = {}
        for path, state, cfg in ((qwen_dir, qwen, QWEN3_0_6B_HF), (nt_dir, nt, NT_V2_500M_HF)):
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(cfg, f)
            t0 = time.perf_counter()
            save_file(state, os.path.join(path, "model.safetensors"), {"format": "pt"})
            written[path] = (os.path.getsize(os.path.join(path, "model.safetensors")),
                             time.perf_counter() - t0)
        with open(os.path.join(nt_dir, "vocab.txt"), "w") as f:
            f.write("\n".join(KmerTokenizer().vocab))
        log(f"pretrained: wrote tokenizer.json (151,643 BPE tokens + 26 added) in {t_tok:.2f} s; "
            f"Qwen3-0.6B bf16 {written[qwen_dir][0] / 1e9:.3f} GB in {written[qwen_dir][1]:.2f} s, "
            f"NT-v2-500M fp32 {written[nt_dir][0] / 1e9:.3f} GB in {written[nt_dir][1]:.2f} s")

        # load times and rates, then (2) the whole fusion, held leaf by leaf
        # to what was written after the cast to each parameter's dtype
        for name, loader, path in (("Qwen3-0.6B", P.load_pretrained_decoder, qwen_dir),
                                   ("NT-v2-500M", P.load_pretrained_encoder, nt_dir)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, module = loader(path, "cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            size = written[path][0]
            log(f"pretrained [{card}]: load_pretrained_{'decoder' if 'Qwen' in name else 'encoder'}"
                f"({name}) onto the card in {dt:.2f} s, {size / dt / 1e9:.2f} GB/s of "
                f"safetensors (the file just written: page cache warm)")
            out[f"load_{name}_GBps"] = size / dt / 1e9
            del module
        t0 = time.perf_counter()
        cfg, model, tok, dna_tok = P.load_pretrained_fusion(qwen_dir, nt_dir, device="cuda")
        torch.cuda.synchronize()
        log(f"pretrained: load_pretrained_fusion in {time.perf_counter() - t0:.2f} s "
            f"(tokenizer included); DNA ids {tok.dna_start_id}, {tok.dna_pad_id}, "
            f"{tok.dna_end_id}; vocab {cfg.decoder.vocab_size}; encoder swiglu "
            f"{cfg.encoder.use_swiglu}, mlp_bias {cfg.encoder.mlp_bias}")
        if (tok.dna_start_id, tok.dna_pad_id, tok.dna_end_id) != (151669, 151670, 151671):
            fail(f"the DNA tokens landed at {tok.dna_start_id}..{tok.dna_end_id}")
        d, e, qc, nc = cfg.decoder, cfg.encoder, QWEN3_0_6B_HF, NT_V2_500M_HF
        if ((d.num_layers, d.hidden_size, d.num_heads, d.num_kv_heads, d.head_dim,
             d.vocab_size, d.rope_theta) != tuple(qc[k] for k in (
                 "num_hidden_layers", "hidden_size", "num_attention_heads",
                 "num_key_value_heads", "head_dim", "vocab_size", "rope_theta"))
                or (e.num_layers, e.hidden_size, e.num_heads, e.intermediate_size,
                    e.vocab_size) != tuple(nc[k] for k in (
                        "num_hidden_layers", "hidden_size", "num_attention_heads",
                        "intermediate_size", "vocab_size"))
                or not e.use_swiglu or e.mlp_bias or not e.attn_bias):
            fail(f"configs from config.json: {cfg}")
        checked, wrong = 0, []
        for exported, state in ((export_decoder_to_hf(model.decoder), qwen),
                                (export_encoder_to_hf(model.encoder), nt)):
            for k, v in exported.items():
                checked += 1
                if k not in state or not torch.equal(v, state[k].to(v.dtype)):
                    wrong.append(k)
        ignored = sorted(set(nt) - set(export_encoder_to_hf(model.encoder)))
        log(f"pretrained: {checked} leaves equal to the written tensors after the cast to "
            f"their parameter's dtype (bf16 weights, fp32 norms) bit for bit: "
            f"{checked - len(wrong)}; not imported: {len(ignored)} rotary buffers")
        if wrong or any("rotary" not in k for k in ignored):
            fail(f"imported leaves differ from the written ones: {wrong[:6]} {ignored[:6]}")
        # the BPE on the served prompts (host time)
        items = variant_items(8, PRETRAINED_BP, seed=1)
        t0 = time.perf_counter()
        prepare_batch(BioProcessor(tok, dna_tok), cfg, items)
        tok_ms = (time.perf_counter() - t0) * 1e3
        log(f"pretrained: prepare_batch of 8 requests (chat render, BPE on 151,643 tokens, "
            f"6-mers of 2 x {PRETRAINED_BP} bp) {tok_ms:.1f} ms of host time (cold BPE cache)")
        out["tokenize_8_ms"] = tok_ms
        del model, qwen, nt
        torch.cuda.empty_cache()

        # (3) train_sft from the two directories on the coding variant-effect
        # task: 4 steps, eval every 2 with top-1 kept, the generative test
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        with open(os.path.join(data_dir, "variant_effect_coding.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in variant_items(16, PRETRAINED_BP)))
        from bioreason_tpu_torch.cli.common import load_items
        train_items, val_items, test_items = load_items("variant_effect_coding", data_dir, 0, 0,
                                                        0)
        steps, bs = 4, 2
        evals = steps // 2
        val_batches = -(-len(val_items) // bs)
        test_calls = -(-len(test_items) // bs)
        # a training step: the frozen encoder once (no autograd), each
        # decoder layer's forward twice (remat) and its backward once; an
        # eval batch: encoder and decoder once; a test batch: one prefill
        # (encoder + decoder; decode steps are plain)
        per_step = {"flash_fwd": ENCODER_LAYERS + 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
        per_eval = ENCODER_LAYERS + DECODER_LAYERS
        want = {"flash_fwd": steps * per_step["flash_fwd"]
                + (evals * val_batches + test_calls) * per_eval,
                "flash_bwd": steps * per_step["flash_bwd"]}
        ck = os.path.join(tmp, "ck")
        argv = ["--hf_llm_dir", qwen_dir, "--hf_dna_dir", nt_dir, "--dataset_type",
                "variant_effect_coding", "--data_dir", data_dir, "--max_steps", str(steps),
                "--batch_size", str(bs), "--eval_every", "2", "--keep_top_k", "1",
                "--test_generative", "--max_new_tokens", "16", "--truncate_dna_per_side", "0",
                "--seed", "0", "--checkpoint_dir", ck]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # --- the main path: counts from 0 just before, read just after -------
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        # ---------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        hist = trainer.history
        res = trainer.test_result
        log(f"pretrained train_sft [{card}]: {steps} steps (variant_effect_coding, "
            f"{len(train_items)}/{len(val_items)}/{len(test_items)} items, B={bs}, vocab "
            f"151,936) in {secs:.1f} s (load, data, eval, test and checkpoints included): losses "
            f"{[round(m['loss'], 4) for m in hist]}, val_loss "
            f"{[round(m['val_loss'], 4) for m in hist if 'val_loss' in m]}, step ms "
            f"{[round(m['step_time'] * 1e3, 1) for m in hist]}, "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; test {res.total} items "
            f"{res.summary()}; launches {got} (expected {want}: {per_step} a step, "
            f"{per_eval} per eval batch x {evals * val_batches} and per test call x "
            f"{test_calls})")
        if len(hist) != steps or not all(math.isfinite(m["loss"]) for m in hist):
            fail(f"train_sft from HF dirs did not run {steps} finite steps")
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"train_sft from HF dirs launched {got}, expected {want}")
        if res is None or res.total != len(test_items):
            fail("the generative test did not score the test split")
        best = os.listdir(os.path.join(ck, "best"))
        if sorted(best)[-1] != "index.json" or len(best) != 2:
            fail(f"--keep_top_k 1 kept {best}")
        b_leaves = [p for n, p in trainer.trainable_state().items() if n.endswith("lora_b")]
        moved = sum(bool(p.detach().any()) for p in b_leaves)
        log(f"pretrained train_sft: {moved} of {len(b_leaves)} LoRA B leaves moved; "
            f"per-layer norm scales stored in "
            f"{trainer.model.decoder.layers[0].ln1.scale.dtype}, final norm in "
            f"{trainer.model.decoder.final_norm.scale.dtype}")
        if moved != len(b_leaves):
            fail("LoRA B leaves did not move")
        if trainer.model.decoder.layers[0].ln1.scale.dtype != torch.bfloat16:
            fail("frozen per-layer norm scales are not stored in bf16")
        out["sft"] = {"step_ms": [m["step_time"] * 1e3 for m in hist], "peak_gib": peak / 2**30,
                      "launches": got}
        sft_model = trainer.model

        # (4) reason from a reference-format .pt exported from that model
        ref = os.path.join(tmp, "reference_sft.pt")
        t0 = time.perf_counter()
        torch.save(export_reference_sft(merge_lora(copy.deepcopy(sft_model))), ref)
        log(f"pretrained: export_reference_sft of the merged SFT model, "
            f"{os.path.getsize(ref) / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s")
        del trainer
        torch.cuda.empty_cache()
        step_s = []
        real_step = grpo_mod.GRPOTrainer.step

        def timed_step(self, *a, **kw):
            t = time.perf_counter()
            m = real_step(self, *a, **kw)
            step_s.append(time.perf_counter() - t)
            return m
        g, n_gen, new = 4, 8, 32
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        grpo_mod.GRPOTrainer.step = timed_step
        try:
            t0 = time.perf_counter()
            cli = reason.main(["--hf_llm_dir", qwen_dir, "--hf_dna_dir", nt_dir,
                               "--sft_checkpoint", ref, "--dataset_type",
                               "variant_effect_coding", "--data_dir", data_dir,
                               "--truncate_dna_per_side", "0", "--num_generations", str(g),
                               "--batch_size", str(n_gen), "--max_completion_length", str(new),
                               "--max_steps", "2", "--seed", "0", "--checkpoint_dir",
                               os.path.join(tmp, "grpo"), "--log_dir",
                               os.path.join(tmp, "grpo_logs")])
            secs = time.perf_counter() - t0
        finally:
            grpo_mod.GRPOTrainer.step = real_step
        peak = torch.cuda.max_memory_allocated()
        hist = cli.metrics_history
        stats = cli.engine.last_stats
        log(f"pretrained reason [{card}]: 2 GRPO steps from the reference .pt at the 151,936 "
            f"vocabulary ({n_gen // g} prompts x G={g}, P={stats['prompt_len']}, {new} new "
            f"tokens) in {secs:.1f} s (load included): step s "
            f"{[round(x, 2) for x in step_s]}, {n_gen / min(step_s):.3f} completions/s "
            f"(fastest step), torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; losses "
            f"{[m['loss'] for m in hist]}, kl {[m['kl'] for m in hist]}, rewards "
            f"{[m['reward'] for m in hist]}; launches {counts()}")
        if len(hist) != 2 or any(not math.isfinite(m[k]) for m in hist
                                 for k in ("loss", "kl", "reward")):
            fail(f"reason from a reference checkpoint: {hist}")
        # a GRPO step: the rollout's encoder and prefill, the reference
        # pass's encoder and decoder, the update's encoder and its decoder
        # twice (remat), one backward per decoder layer (as phase 8)
        want = {"flash_fwd": 2 * (3 * ENCODER_LAYERS + 4 * DECODER_LAYERS),
                "flash_bwd": 2 * DECODER_LAYERS}
        if counts() != {k: want.get(k, 0) for k in counts()}:
            fail(f"reason launched {counts()} in 2 steps, expected {want}")
        out["grpo"] = {"step_s": step_s, "completions_per_s": n_gen / min(step_s),
                       "peak_gib": peak / 2**30, "launches": counts()}
        del cli
        torch.cuda.empty_cache()

        # (5) serve --checkpoint <sft_final>: 8 concurrent greedy requests twice
        t0 = time.perf_counter()
        server = build_server(checkpoint=os.path.join(ck, "sft_final"), max_length_dna=2048,
                              max_batch=8, batch_window_ms=500.0, max_new_tokens=max_new,
                              greedy_default=True)
        log(f"pretrained serve: the sft_final's base rebuilt and its LoRA merged in "
            f"{time.perf_counter() - t0:.1f} s")
        reqs = variant_items(8, PRETRAINED_BP, seed=2)
        batch = [torch.as_tensor(a, device="cuda")
                 for a in prepare_batch(server.processor, server.cfg, reqs[:1])]
        served = server.engine.prefill(server.model, *batch, max_new)[0]
        unmerged = GenerationEngine(server.cfg, tok.eos_token_id).prefill(sft_model, *batch,
                                                                          max_new)[0]
        cos = float(torch.nn.functional.cosine_similarity(served, unmerged, dim=-1).min())
        rel = float((served - unmerged).abs().max() / unmerged.abs().max())
        log(f"pretrained serve: merged (served) vs unmerged (the SFT model) last-column prefill "
            f"logits [1, {served.shape[-1]}]: cosine {cos:.6f}, max |diff| / max |logit| "
            f"{rel:.3g} (tolerance: cosine >= {MERGED_COS}, relative <= {MERGED_REL}: bf16 "
            f"merge rounding)")
        if not bool(torch.isfinite(served).all()) or cos < MERGED_COS or rel > MERGED_REL:
            fail("served merged model and the SFT model disagree")
        del sft_model, unmerged
        torch.cuda.empty_cache()
        server.start()
        calls_out, restore = record_engine_calls(server)
        torch.cuda.reset_peak_memory_stats()
        # --- the main path: counts from 0 just before, read just after -------
        reset_counts()
        calls0 = server.engine_calls
        first = burst(server, reqs, max_new)
        n_first = len(calls_out)
        second = burst(server, reqs, max_new)
        got = counts()
        calls = server.engine_calls - calls0
        # ---------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        server.stop()
        restore()
        if (len(completion_rows(calls_out[:n_first])) != 8 or first != second
                or completion_rows(calls_out[:n_first]) != completion_rows(calls_out[n_first:])):
            fail("serve --checkpoint: greedy repeats differ")
        per_call = ENCODER_LAYERS + DECODER_LAYERS
        st = calls_out[-1][1]
        tps = st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0
        log(f"pretrained serve [{card}]: 16 requests in {calls} engine calls, flash_fwd "
            f"{got['flash_fwd']} = {got['flash_fwd'] / max(calls, 1):g} per call (expected "
            f"{per_call}); B={st['batch']} P={st['prompt_len']}: prefill "
            f"{st['prefill_s'] * 1e3:.1f} ms, decode {tps:.1f} tokens/s; "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; e.g. "
            f"{first[0]['completion'][:60]!r}")
        if got != {k: (per_call * calls if k == "flash_fwd" else 0) for k in got}:
            fail(f"serve --checkpoint launched {got} in {calls} engine calls")
        out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                        "prefill_ms": st["prefill_s"] * 1e3, "decode_tps": tps,
                        "peak_gib": peak / 2**30}
        del server
        torch.cuda.empty_cache()

        # (6) train_sft --hf_llm_dir with --evo2_dir over the committed
        # 25-block fixture (head_dim 8: its attention takes the plain route)
        evo2_dir = os.path.join(tmp, "evo2")
        os.makedirs(evo2_dir)
        shutil.copy(os.path.join(REPO, "tests", "assets", "evo2_1b_depth_tiny.pt"), evo2_dir)
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_sft.main(["--hf_llm_dir", qwen_dir, "--evo2_dir", evo2_dir,
                                  "--dna_attention", "xla", "--max_steps", "2", "--seed", "0",
                                  "--max_length_dna", "256", "--n_synthetic", "16",
                                  "--checkpoint_dir", os.path.join(tmp, "evo2_ck")])
        got = counts()
        hist = trainer.history
        want = {"flash_fwd": 2 * 2 * DECODER_LAYERS, "flash_bwd": 2 * DECODER_LAYERS}
        log(f"pretrained train_sft --evo2_dir [{card}]: 2 steps in "
            f"{time.perf_counter() - t0:.1f} s, losses {[round(m['loss'], 4) for m in hist]}, "
            f"launches {got} (expected {want})")
        if len(hist) != 2 or not all(math.isfinite(m["loss"]) for m in hist):
            fail("train_sft --evo2_dir did not run 2 finite steps")
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"train_sft --evo2_dir launched {got}, expected {want}")
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"pretrained: phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 12 -----------------------------------------------------------------

GUIDED = r"<answer>(yes|no)</answer>"
# teacher-forced batcher vs engine logits (bf16, two cache layouts and
# attention routes): per row and step, and at the first token (one prefill
# each, the flash kernel in both)
CONT_STEP_COS, CONT_FIRST_COS = 0.999, 0.9999
CONT_BUDGET_S = 75.0
CONT_NEW, CONT_WINDOW = 24, 16
# (a)'s requests: 1.5 x capacity, not the bench's 3 x, so that the phase and
# the script keep their budgets on a slower host (the queue stays: 96
# requests over 64 slots); its and phase 14 (f)'s longest completion: 64
# tokens, not the bench's 128, for the script's time
CONT_REQUESTS, CONT_MAX_NEW = 96, 64


def teacher_forced(torch, engine, model, batch, streams):
    """The engine's logits [B, n, V] on given token streams [B, n]: its
    prefill's last column, then one decode step of engine.generate's loop
    per token, the token forced."""
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    ids, mask, dna, dmask = batch
    b, p = ids.shape
    n = streams.shape[1]
    lens = mask.sum(-1)
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        first, cache, cmask = engine.prefill(model, ids, mask, dna, dmask, n)
        out = [first]
        for j in range(1, n):
            cmask[:, p + j - 1] = 1
            lg, cache = decoder_forward(model.decoder, engine.cfg.decoder,
                                        input_ids=streams[:, j - 1:j], attention_mask=ones,
                                        positions=(lens + j - 1)[:, None], cache=cache,
                                        cache_index=p + j - 1, cache_mask=cmask)
            out.append(lg[:, 0])
    return torch.stack(out, 1)


def batcher_run(torch, cb, reqs, preempt=None):
    """Phase 12(b)'s schedule on `cb`: the first 4 requests admitted, one
    window, the other 4 (and, with `preempt`, that request evicted after
    the first window and re-admitted with them), windows until all finish.
    Returns {rid: {token index: fp32 logits [V]}} of every decode step,
    recorded by patching `layers.lm_logits` during each window."""
    from bioreason_tpu_torch.models import layers as L
    orig, captured, logits = L.lm_logits, [], {}

    def recording(dec, h):
        out = orig(dec, h)
        captured.append(out)
        return out

    def window():
        pend = {id(r) for rec in cb._pending_first for r, _ in rec.req_src}
        snap = [(s, r, len(r.tokens) + (id(r) in pend)) for s, r in enumerate(cb._by_slot)
                if r is not None and cb.active[s]]
        captured.clear()
        L.lm_logits = recording
        try:
            cb.step_window(CONT_WINDOW)
        finally:
            L.lm_logits = orig
        for s, r, base in snap:
            for j, lg in enumerate(captured):
                if base + j < r.max_new_tokens:          # the overrun is discarded
                    logits.setdefault(r.rid, {})[base + j] = lg[s].flatten()
    cb.admit_many(list(reqs[:4]))
    window()
    late = list(reqs[4:])
    if preempt is not None:
        late.append(cb.preempt(reqs[preempt].slot))
    cb.admit_many(late)
    while cb.active.any() or cb._pending_first:
        window()
    return logits


def sync_warnings(torch, fn):
    """The host syncs torch's sync debug mode ("warn") reports while fn()
    runs, as their messages."""
    import warnings
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in got if "called a synchronizing" in str(w.message)]


def count_syncs(torch, cb, k):
    """The host syncs that one k-step decode window's dispatch makes
    (`_multi_step` alone), and those of a control that syncs once."""
    real, seen = cb._multi_step, []

    def counted(*a, **kw):
        out = []
        seen.extend(sync_warnings(torch, lambda: out.append(real(*a, **kw))))
        return out[0]
    cb._multi_step = counted
    try:
        cb.step_window(k)
    finally:
        del cb._multi_step
    return seen, sync_warnings(torch, lambda: torch.ones(1, device="cuda").item())


def phase_continuous(torch, card):
    """Continuous serving at full width (module docstring, phase 12)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.data.kegg import synthetic_kegg_items
    from bioreason_tpu_torch.data.text_tokenizer import load_hf_tokenizer
    from bioreason_tpu_torch.generate import continuous as C
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.generate.guided import guided_spec_for
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.serve import (InferenceServer, build_config, make_http_server,
                                           prepare_request)
    from bioreason_tpu_torch.tools import bench_serve
    t_phase = time.perf_counter()
    per_chunk = ENCODER_LAYERS + DECODER_LAYERS
    out = {}

    # (a) the serving bench, at its defaults but CONT_REQUESTS and
    # CONT_MAX_NEW: the main
    # path, counts from 0 just before and read just after (its warmup's one
    # prefill included)
    reset_counts()
    res = bench_serve.main(["--probe", "--requests", str(CONT_REQUESTS), "--max_new",
                            str(CONT_MAX_NEW), "--frozen", "bfloat16"])
    got = counts()
    torch.cuda.empty_cache()
    log(f"continuous bench [{card}]: {res['value']:.1f} decoded tokens/s ({res['decoded_tokens']} "
        f"tokens, {res['requests']} requests over {res['capacity']} slots in "
        f"{res['seconds']:.2f} s; host: admit {res['admit_s']:.2f} s, decode "
        f"{res['decode_s']:.2f} s); {res['windows']} windows of {res['window']}, mean "
        f"occupancy {res['mean_occupancy']:.3f}; {res['prefill_calls']} prefill calls, "
        f"flash_fwd {res['flash_fwd_launches']} = {res['flash_fwd_per_prefill']:g} per prefill "
        f"chunk; pools {res['pool_gib']:.3f} GiB, torch.cuda.max_memory_allocated "
        f"{res['peak_gib']:.2f} GiB; launches with the warmup {got}")
    if res["flash_fwd_launches"] != per_chunk * res["prefill_calls"]:
        fail(f"the bench's {res['prefill_calls']} prefill chunks launched flash_fwd "
             f"{res['flash_fwd_launches']} times, expected {per_chunk} each and none in a "
             f"decode window")
    if got != {k: (per_chunk * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
               for k in got}:
        fail(f"the bench launched {got}: expected {per_chunk} flash_fwd per prefill chunk "
             f"(and its warmup's one) and nothing else")
    out["bench"] = {**res, "launches": got["flash_fwd"]}

    # (b) the batcher against the engine at full width: phase 4's requests
    cfg, processor = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    model = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    items, padded = served_inputs()
    arrays = [prepare_request(processor, cfg, it) for it in items]

    def batcher(**kw):
        return C.ContinuousBatcher(model, cfg, eos_token_id=-1, capacity=8, max_len=1024,
                                   max_new=CONT_NEW, prompt_bucket=128, **kw)

    def requests(greedy=True):
        return [C.Request(i, *a, max_new_tokens=CONT_NEW, greedy=greedy)
                for i, a in enumerate(arrays)]
    batch = [torch.as_tensor(a, device="cuda") for a in padded]
    engine = GenerationEngine(cfg, eos_token_id=-1)
    cb = batcher()
    first_b = cb._prefill(*batch)[1]           # the admission prefill, all 8 in one chunk
    t0 = time.perf_counter()
    runs, logits = [], []
    for preempt in (None, None, 1):
        reqs = requests()
        logits.append(batcher_run(torch, batcher(), reqs, preempt))
        runs.append([list(r.tokens) for r in reqs])
    t_runs = time.perf_counter() - t0
    if runs[1] != runs[0]:
        fail("greedy repeats of the batcher differ")
    if any(len(toks) != CONT_NEW for run in runs for toks in run):
        fail(f"a request did not get its {CONT_NEW} tokens")
    # teacher-forced on each run's own streams (run 3's preempted request
    # follows its own after the re-admission)
    cos_steps, refs = [], []
    for run, lg in zip(runs[1:], logits[1:]):
        refs.append(teacher_forced(torch, engine, model, batch, torch.tensor(run, device="cuda")))
        for rid, steps in lg.items():
            for j, row in steps.items():
                cos_steps.append(float(F.cosine_similarity(row, refs[-1][rid, j], dim=0)))
    cos_first = F.cosine_similarity(first_b, refs[0][:, 0], dim=-1)
    n_steps = len(cos_steps)
    ids, mask = engine.generate(model, *batch, greedy=True, max_new_tokens=CONT_NEW)
    agree = [next((j for j, (a, b) in enumerate(zip(row, ref_row)) if a != b), CONT_NEW)
             for row, ref_row in zip(runs[0], ids.tolist())]
    cont_agree = next((j for j, (a, b) in enumerate(zip(runs[2][1], runs[0][1])) if a != b),
                      CONT_NEW)
    log(f"continuous vs engine [{card}]: 8 requests (P = {batch[0].shape[1]} in the engine's "
        f"batch, slot_len 1024, window {CONT_WINDOW}), admitted 4 + 4; 3 batcher runs in "
        f"{t_runs:.2f} s; teacher-forced logits cosine min {min(cos_steps):.6f} over "
        f"{n_steps} (row, step) pairs (>= {CONT_STEP_COS}), first token min "
        f"{float(cos_first.min()):.6f} (>= {CONT_FIRST_COS}); greedy repeats identical; "
        f"free-running greedy tokens equal to the engine's for the first {agree} of "
        f"{CONT_NEW} (not gated: bf16 near-ties at random weights); the request preempted "
        f"after one window and re-admitted matches its uninterrupted tokens for "
        f"{cont_agree} of {CONT_NEW}")
    # every decode step of both runs, but the preempted request's token 17:
    # its re-admission's prefill draws it
    if n_steps != 2 * 8 * (CONT_NEW - 1) - 1 or min(cos_steps) < CONT_STEP_COS:
        fail(f"batcher vs engine logits: {n_steps} steps, min cosine {min(cos_steps):.6f}")
    if float(cos_first.min()) < CONT_FIRST_COS:
        fail(f"batcher vs engine first-token logits: cosine {float(cos_first.min()):.6f}")
    # no host sync inside a window: 4 sampled rows, their second window
    cb = batcher(sampling=SamplingConfig(temperature=0.6, top_p=0.95, top_k=20))
    cb.admit_many(requests(greedy=False)[:4])
    cb.step_window(CONT_WINDOW)
    reset_counts()
    syncs, control = count_syncs(torch, cb, CONT_WINDOW)
    window_launches = counts()
    log(f"continuous: one sampled window of {CONT_WINDOW} steps: {len(syncs)} host syncs "
        f"{syncs[:3]} (a control's .item(): {len(control)}); launches in one window "
        f"{window_launches}")
    if syncs or not control or any(window_launches.values()):
        fail("a decode window synced with the host (or the check saw no sync in its "
             "control), or launched an attention kernel")
    out["engine"] = {"cos_min": min(cos_steps), "first_cos_min": float(cos_first.min()),
                     "greedy_agree": agree, "preempt_agree": cont_agree}
    del cb
    torch.cuda.empty_cache()

    # (c) tiers and guided decoding over HTTP, then the BPE tokenizer
    prefills, orig_prefill = [], C.ContinuousBatcher._prefill

    def recording_prefill(self, ids, mask, dna, dmask):
        prefills.append((self.max_len, mask.clone()))
        return orig_prefill(self, ids, mask, dna, dmask)
    server = InferenceServer(model, cfg, processor, max_new_tokens=32, continuous=True,
                             tiers="8x512,8x1024", decode_window=8, guided_regex=GUIDED)
    C.ContinuousBatcher._prefill = recording_prefill
    server.start()
    httpd = make_http_server(server, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    http_items = [{**it, "question": it["question"] + " Explain briefly." * i}
                  for bp, seed in ((2048, 3), (600, 4))
                  for i, it in enumerate(synthetic_kegg_items(n=6, seq_len=bp, seed=seed))]
    answers = [None] * len(http_items)

    def post(i):
        it = http_items[i]
        body = json.dumps({k: it[k] for k in ("question", "reference_sequence",
                                              "variant_sequence")}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[i] = (r.status, json.loads(r.read()))
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(http_items))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        C.ContinuousBatcher._prefill = orig_prefill
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    t_http = time.perf_counter() - t0
    if any(a is None or a[0] != 200 for a in answers):
        fail(f"not every request was answered: {answers}")
    bad = [a[1]["completion"] for a in answers if not re.fullmatch(GUIDED, a[1]["completion"])]
    tiers = [(cb.capacity, cb.max_len) for cb in server.batchers]
    log(f"continuous serve [{card}]: tiers {tiers}, requests routed {server.routed}, "
        f"{len(answers)} answered over HTTP in {t_http:.2f} s (sampled, decode window 8), "
        f"{len(answers) - len(bad)} fullmatch {GUIDED!r}; e.g. {answers[0][1]['completion']!r}; "
        f"{len(prefills)} prefill chunks {[tuple(m.shape) for _, m in prefills]}")
    if bad or server.routed != [6, 6]:
        fail(f"tiers or guided decoding: routed {server.routed}, not matching {bad}")
    # the BPE tokenizer of phase 11 under the 151,936-row head
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_guided_", dir=build_dir)
    try:
        write_qwen_tokenizer(tmp)
        tok = load_hf_tokenizer(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    spec = guided_spec_for(tok, GUIDED, vocab_size=cfg.decoder.vocab_size, device="cuda")
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    enc = tok([f"Question {i}: is this variant pathogenic?" * (i + 1) for i in range(4)],
              padding_side="left")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids, mask = GenerationEngine(cfg, eos_token_id=tok.eos_token_id).generate(
        model, enc["input_ids"], enc["attention_mask"], sampling=SamplingConfig(
            temperature=0.6, top_p=0.95, top_k=20), max_new_tokens=32, generator=gen,
        guided=spec)
    texts = tok.batch_decode([r[m.astype(bool)] for r, m in zip(ids, mask)])
    dead_tail = bool((spec.next_state[:, tok.vocab_size:] == spec.dead).all())
    log(f"continuous guided BPE: the spec [{spec.next_state.shape[0]}, "
        f"{spec.next_state.shape[1]}] over {tok.vocab_size} tokenizer ids built in "
        f"{t_spec:.3f} s of host time, the columns past them dead: {dead_tail}; 4 sampled "
        f"engine requests: {texts}")
    if not dead_tail or not all(re.fullmatch(GUIDED, t) for t in texts):
        fail(f"guided decoding over the BPE tokenizer: {texts}")
    out["guided"] = {"spec_s": t_spec, "routed": server.routed, "http_s": t_http}
    del server, spec

    # (d) flash_fwd at this path's shapes
    long_chunks = [m for mlen, m in prefills if mlen == 1024]
    mixed = max(long_chunks, key=lambda m: (m.shape[0], len(set(m.sum(-1).tolist()))))
    ones = lambda b, t: torch.ones((b, t), dtype=torch.int32, device="cuda")
    rows = [kernel_case(torch, "continuous_prefill_K64_W256", 64, 256, 256, 16, 8, 128, True,
                        0, ones(64, 256), 41),
            kernel_case(torch, "continuous_encoder_K64_T128", 64, 128, 128, 16, 16, 64, False,
                        None, ones(64, 128), 42),
            kernel_case(torch, f"continuous_tier_K{mixed.shape[0]}_W{mixed.shape[1]}_leftpad",
                        mixed.shape[0], mixed.shape[1], mixed.shape[1], 16, 8, 128, True, 0,
                        mixed.to(torch.int32), 43)]
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"continuous: phase done in {out['seconds']:.1f} s (budget {CONT_BUDGET_S:g})")
    if out["seconds"] > CONT_BUDGET_S:
        fail(f"the continuous phase took {out['seconds']:.1f} s, over {CONT_BUDGET_S:g}")
    return out, rows


# -- phase 13 -----------------------------------------------------------------

CLS_B, CLS_L, CLS_CLASSES = 16, 512, 8          # bench_classifier.py's shape
CLS_FT_STEPS = 4                                 # finetune steps on one fixed batch
CLS_BUDGET_S = 60.0


def classifier_batch(b=CLS_B, t=CLS_L, classes=CLS_CLASSES, seed=0):
    """bench_classifier.py's batch: random 6-mer ids, all valid."""
    npr = np.random.default_rng(seed)
    return {"ref_ids": npr.integers(6, 4102, (b, t)).astype(np.int32),
            "alt_ids": npr.integers(6, 4102, (b, t)).astype(np.int32),
            "ref_attention_mask": np.ones((b, t), np.int32),
            "alt_attention_mask": np.ones((b, t), np.int32),
            "labels": npr.integers(0, classes, b).astype(np.int32)}


def phase_classifier(torch, card):
    """The DNA-only classifier at NT-v2-500M width (module docstring, phase
    13)."""
    from bioreason_tpu_torch.cli import train_dna_only
    from bioreason_tpu_torch.config import EncoderConfig, OptimConfig
    from bioreason_tpu_torch.models.classifier import classifier_forward
    from bioreason_tpu_torch.tools import bench_classifier
    from bioreason_tpu_torch.train.checkpoint import load_classifier
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    t_phase = time.perf_counter()
    per_step = 2 * ENCODER_LAYERS                    # ref and alt through the encoder
    out = {}

    # (a) frozen: bench_classifier.py's run, the main path (counts from 0
    # just before and read just after: 2 warm-up + 5 x 10 timed + 1 profiled)
    reset_counts()
    res = bench_classifier.main([])
    got = counts()
    steps = 2 + bench_classifier.REPS * bench_classifier.STEPS + 1
    log(f"classifier bench [{card}]: {res['value']:.2f} examples/s (median of "
        f"{[round(r, 2) for r in res['repetitions']]}), {res['ms_per_step']:.2f} ms a step; "
        f"profiled step busy {res['profiled_step_busy_ms']:.2f} of "
        f"{res['profiled_step_wall_ms']:.2f} ms; loss {res['loss']:.4f}; "
        f"torch.cuda.max_memory_allocated {res['peak_gib']:.2f} GiB; launches {got} over "
        f"{steps} steps")
    if got != {k: per_step * steps if k == "flash_fwd" else 0 for k in got}:
        fail(f"the frozen classifier launched {got} in {steps} steps, expected "
             f"{per_step} flash_fwd a step and no flash_bwd")
    if not math.isfinite(res["loss"]):
        fail(f"the frozen classifier's loss is {res['loss']}")
    out["frozen"] = {**res, "launches": got["flash_fwd"], "steps": steps}
    torch.cuda.empty_cache()

    # (b) --finetune_encoder at the bench's shape, remat off as the bench
    # runs it: fp32 masters and AdamW moments for the whole encoder
    cfg = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim) != (29, 1024, 16, 64):
        fail(f"the classifier's encoder is not at NT-v2-500M width: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    trainer = ClassifierTrainer(cfg, CLS_CLASSES, optim=OptimConfig(
        learning_rate=1e-3, total_steps=100, warmup_ratio=0.0),
        train_just_classifier=False, device="cuda")
    batch = classifier_batch()
    losses = [trainer.train_step(batch)["loss"]]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(CLS_FT_STEPS - 1):
        losses.append(trainer.train_step(batch)["loss"])
    ms = (time.perf_counter() - t0) * 1e3 / (CLS_FT_STEPS - 1)
    got = counts()
    n_train = sum(p.numel() for p in trainer.params)
    log(f"classifier finetune [{card}]: remat off, {n_train / 1e6:.1f} M trainable parameters; "
        f"{ms:.1f} ms a step ({CLS_B * 1e3 / ms:.2f} examples/s) over {CLS_FT_STEPS - 1} "
        f"timed steps; losses {[round(x, 4) for x in losses]} on one fixed batch; launches "
        f"{got}; torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    n = CLS_FT_STEPS - 1
    if got != {"flash_fwd": per_step * n, "flash_bwd": per_step * n, "local_fwd": 0,
               "local_bwd": 0}:
        fail(f"the finetuned classifier launched {got} in {n} steps, expected {per_step} "
             f"flash_fwd and {per_step} flash_bwd a step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the finetuned classifier's loss did not fall on a fixed batch: {losses}")
    # one step with the preset's remat on: each layer's forward runs again
    trainer.cfg = dataclasses.replace(cfg, remat=True)
    reset_counts()
    trainer.train_step(batch)
    got_remat = counts()
    log(f"classifier finetune, one step with remat on: launches {got_remat}")
    if got_remat["flash_fwd"] != 2 * per_step or got_remat["flash_bwd"] != per_step:
        fail(f"with remat on a finetune step launched {got_remat}, expected "
             f"{2 * per_step} flash_fwd and {per_step} flash_bwd")
    out["finetune"] = {"ms": ms, "losses": losses, "launches": got,
                       "remat_launches": got_remat,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer
    torch.cuda.empty_cache()

    # (c) the kernels at the classifier's shapes: all valid, and the
    # collate's right pads (reads of 60-512 tokens)
    g = torch.Generator(device="cuda").manual_seed(13)
    ones = torch.ones((CLS_B, CLS_L), dtype=torch.int32, device="cuda")
    padded = right_padded(torch, CLS_B, CLS_L, 60, g)
    rows = [kernel_case(torch, "classifier_encoder_B16_T512", CLS_B, CLS_L, CLS_L, 16, 16, 64,
                        False, None, ones, 131),
            kernel_case(torch, "classifier_encoder_B16_T512_rightpad", CLS_B, CLS_L, CLS_L, 16,
                        16, 64, False, None, padded, 132)]
    bwd_rows = [bwd_case(torch, "classifier_finetune_B16_T512", CLS_B, CLS_L, CLS_L, 16, 16, 64,
                         False, 0, ones, 133),
                bwd_case(torch, "classifier_finetune_B16_T512_rightpad", CLS_B, CLS_L, CLS_L,
                         16, 16, 64, False, 0, padded, 134)]

    # (d) the CLI on synthetic items: it trains, tests and writes
    # dna_only_final, which the loader rebuilds to the same logits
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_cls_", dir=build_dir)
    try:
        reset_counts()
        t0 = time.perf_counter()
        cli = train_dna_only.main(["--max_steps", "3", "--batch_size", "4", "--n_synthetic",
                                   "32", "--max_length_dna", "512", "--checkpoint_dir", tmp,
                                   "--log_dir", os.path.join(tmp, "logs")])
        secs = time.perf_counter() - t0
        got = counts()
        model, labels = load_classifier(os.path.join(tmp, "dna_only_final"), cli.cfg,
                                        encoder="nt-500m", device="cuda")
        small = {k: torch.as_tensor(v, device="cuda")
                 for k, v in classifier_batch(b=4, t=128).items()}
        keys = ("ref_ids", "alt_ids", "ref_attention_mask", "alt_attention_mask")
        with torch.no_grad():
            want = classifier_forward(cli.model, cli.cfg, *(small[k] for k in keys))
            rebuilt = classifier_forward(model, cli.cfg, *(small[k] for k in keys))
        diff = float((rebuilt - want).abs().max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"classifier CLI: train_dna_only --max_steps 3 on 32 synthetic items "
        f"({len(labels)} classes) in {secs:.1f} s, launches {got}; dna_only_final rebuilt "
        f"by load_classifier: logits max abs diff {diff:.3g}")
    if got["flash_fwd"] % per_step or got["flash_bwd"] or diff > 1e-3:
        fail(f"the classifier CLI: launches {got} (expected a multiple of {per_step} "
             f"flash_fwd, no flash_bwd), rebuilt logits off by {diff}")
    out["cli"] = {"seconds": secs, "launches": got}
    del cli, model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"classifier: phase done in {out['seconds']:.1f} s (budget {CLS_BUDGET_S:g})")
    if out["seconds"] > CLS_BUDGET_S:
        fail(f"the classifier phase took {out['seconds']:.1f} s, over {CLS_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 14 -----------------------------------------------------------------

INT8_NEW = 16                  # teacher-forced steps per request in (b) and (c)
# (b) the int8 engine against a bf16 engine holding the dequantized weights:
# the same products but the head's, whose per-row scale the int8 path puts
# on the fp32 logits where the bf16 one rounds it into the weights
INT8_EXACT_COS = 0.9999
# (c) against the bf16 weights: the quantization error itself (per-channel
# int8 steps of ~0.8% of a Gaussian row's spread in every dense, the
# embedding and the head; per-token activations too under W8A8), compounded
# over 57 layers of random weights
INT8_COS_FLOOR, W8A8_COS_FLOOR = 0.98, 0.95
INT8_BUDGET_S = 120.0


def dequantized_copy(torch, q8, template):
    """`template` (a bf16 model of the same config) with every weight that
    is int8 in `q8` replaced by its dequantized bf16 value, as `dense`
    computes it."""
    from bioreason_tpu_torch.models import layers as L
    mods = dict(q8.named_modules())
    with torch.no_grad():
        for name, mod in template.named_modules():
            src = mods.get(name)
            if src is not None and hasattr(src, "weight") and L.is_int8(src):
                mod.weight.copy_(L.int8_weight(src, mod.weight.dtype))
    return template


def w8a8_case(torch, name, m, k, n, seed):
    """`_w8a8_dot` against the product with the dequantized weight at one
    prefill shape [m, k] x [k, n]: the int32 product exact, the relative
    error, and the times of the two."""
    with torch.no_grad():
        return _w8a8_case(torch, name, m, k, n, seed)


def _w8a8_case(torch, name, m, k, n, seed):
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.train.quant import store_int8, quantize_kernel_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    lin = L.linear(k, n, False, "cuda", torch.bfloat16)
    lin.weight.data = (torch.randn((n, k), generator=g, device="cuda") * k ** -0.5).to(
        torch.bfloat16)
    store_int8(lin, *quantize_kernel_int8(lin.weight))
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    exact = bool(torch.equal(L.int8_mm(xq, lin.weight).long(),
                             (xq.double() @ lin.weight.double().t()).long()))
    y8 = L.dense(lin, x, torch.bfloat16, act8=True)
    ref = L.dense(lin, x, torch.bfloat16)
    rel = float((y8.float() - ref.float()).norm() / ref.float().norm())
    w = L.int8_weight(lin, torch.bfloat16)
    ms8 = cuda_ms(lambda: L.dense(lin, x, torch.bfloat16, act8=True), iters=20)
    ms_dq = cuda_ms(lambda: L.dense(lin, x, torch.bfloat16), iters=20)
    ms_bf = cuda_ms(lambda: F.linear(x, w), iters=20)
    flops = 2.0 * m * k * n
    log(f"w8a8 {name} [{m}, {k}] x [{k}, {n}]: int32 product exact {exact}; relative error "
        f"against the dequantized product {rel:.4g}; ms: W8A8 {ms8:.4f} (int8 x int8 -> int32 "
        f"through torch._int_mm, with the activation quantization), weight-only int8 "
        f"{ms_dq:.4f} (dequantize + bf16 GEMM), bf16 GEMM alone {ms_bf:.4f}; "
        f"{flops / (ms8 * 1e-3) / 1e12:.1f} TOP/s")
    if not exact or rel > 0.05:
        fail(f"w8a8 {name}: int32 product exact {exact}, relative error {rel:.4g}")
    return {"shape": name, "M": m, "K": k, "N": n, "exact": exact, "rel_err": rel,
            "w8a8_ms": ms8, "weight_only_ms": ms_dq, "bf16_ms": ms_bf}


def phase_int8(torch, card):
    """int8 weights, W8A8, int8 KV and fused projections at full width
    (module docstring, phase 14)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.serve import build_config, build_server, serving_storage
    from bioreason_tpu_torch.tools import bench_serve
    from bioreason_tpu_torch.train.quant import storage_bytes
    t_phase = time.perf_counter()
    per_call = ENCODER_LAYERS + DECODER_LAYERS
    out = {}
    cfg, _ = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    items, padded = served_inputs()
    batch = [torch.as_tensor(a, device="cuda") for a in padded]

    # (a) resident weight bytes, counted from the modules' storage
    bf = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    q8 = serving_storage(init_fusion(cfg, seed=0, device="cuda").requires_grad_(False),
                         int8=True)
    sizes = {name: (storage_bytes(getattr(bf, name)), storage_bytes(getattr(q8, name)))
             for name in ("encoder", "decoder", "dna_projection")}
    total_bf, total_q8 = storage_bytes(bf), storage_bytes(q8)
    log(f"int8 [{card}]: resident weights {total_bf / 2**30:.3f} GiB bf16 -> "
        f"{total_q8 / 2**30:.3f} GiB --int8 ({total_q8 / total_bf:.3f}); by tower "
        + ", ".join(f"{k} {a / 2**20:.1f} -> {b / 2**20:.1f} MiB" for k, (a, b) in sizes.items()))
    if not 0.45 < total_q8 / total_bf < 0.55:
        fail(f"--int8 holds {total_q8 / total_bf:.3f} of the bf16 bytes, expected about half")
    out["bytes"] = {"bf16": total_bf, "int8": total_q8, "by_tower": sizes}

    # (b) exactness: the int8 engine against a bf16 engine holding the
    # dequantized weights, teacher-forced on the int8 engine's greedy tokens
    engine = GenerationEngine(cfg, eos_token_id=-1)
    ids, _ = engine.generate(q8, *batch, greedy=True, max_new_tokens=INT8_NEW)
    streams = torch.as_tensor(ids, device="cuda")
    lg8 = teacher_forced(torch, engine, q8, batch, streams)
    dq = dequantized_copy(torch, q8, init_fusion(cfg, seed=0, device="cuda"))
    lg_dq = teacher_forced(torch, engine, dq, batch, streams)
    del dq
    cos_exact = F.cosine_similarity(lg8, lg_dq, dim=-1)
    log(f"int8 vs dequantized bf16 weights [{card}]: teacher-forced logits cosine min "
        f"{float(cos_exact.min()):.6f} over {cos_exact.numel()} (row, step) pairs "
        f"(>= {INT8_EXACT_COS}), max abs diff {float((lg8 - lg_dq).abs().max()):.4g}")
    if float(cos_exact.min()) < INT8_EXACT_COS or not bool(torch.isfinite(lg8).all()):
        fail(f"--int8 differs from its own dequantized weights: cosine "
             f"{float(cos_exact.min()):.6f}")

    # (c) the quantization error: --int8 and --int8 --w8a8 against bf16
    ids_bf, _ = engine.generate(bf, *batch, greedy=True, max_new_tokens=INT8_NEW)
    streams_bf = torch.as_tensor(ids_bf, device="cuda")
    lg_bf = teacher_forced(torch, engine, bf, batch, streams_bf)
    cfg8 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, act_int8=True),
                               encoder=dataclasses.replace(cfg.encoder, act_int8=True))
    e8a8 = GenerationEngine(cfg8, eos_token_id=-1)
    quant = {}
    for label, eng in (("int8", engine), ("w8a8", e8a8)):
        lg = teacher_forced(torch, eng, q8, batch, streams_bf)
        cos = F.cosine_similarity(lg, lg_bf, dim=-1)
        top = float((lg.argmax(-1) == lg_bf.argmax(-1)).float().mean())
        quant[label] = {"cos_min": float(cos.min()), "cos_median": float(cos.median()),
                        "argmax_agree": top}
        log(f"{label} vs bf16 weights [{card}]: teacher-forced logits cosine min "
            f"{quant[label]['cos_min']:.6f}, median {quant[label]['cos_median']:.6f} over "
            f"{cos.numel()} (row, step) pairs; argmax agreement {top:.3f}")
    if (quant["int8"]["cos_min"] < INT8_COS_FLOOR or quant["w8a8"]["cos_min"] < W8A8_COS_FLOOR):
        fail(f"quantization error past its floor ({INT8_COS_FLOOR}, {W8A8_COS_FLOOR}): {quant}")
    out["logits"] = {"exact_cos_min": float(cos_exact.min()), **quant}
    del lg8, lg_dq, lg_bf, bf
    torch.cuda.empty_cache()

    # (d) the server with every flag, the main path: counts from 0 just
    # before, read just after; 57 flash_fwd per engine call with the int8
    # KV cache (its prefill attends over its fresh bf16 K/V)
    server = build_server("qwen3-0.6b", "nt-500m", max_length_dna=2048, seed=0, int8=True,
                          fuse=True, w8a8=True, kv_int8=True, max_batch=8,
                          batch_window_ms=500.0, max_new_tokens=INT8_NEW, greedy_default=True)
    server.start()
    calls_out, restore = record_engine_calls(server)
    reset_counts()
    calls0 = server.engine_calls
    try:
        first = burst(server, items, INT8_NEW)
        second = burst(server, items, INT8_NEW)
    finally:
        server.stop()
        restore()
    got = counts()
    calls = server.engine_calls - calls0
    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    st = calls_out[-1][1]
    log(f"int8 serve [{card}] --int8 --kv_int8 --fuse --w8a8: {len(answered)} requests answered "
        f"in {calls} engine calls, launches {got} = {got['flash_fwd'] / max(calls, 1):g} "
        f"flash_fwd per call; last call B={st['batch']} P={st['prompt_len']}: prefill "
        f"{st['prefill_s'] * 1e3:.1f} ms, decode "
        f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tokens/s")
    if (len(answered) != 16 or first != second
            or got != {k: per_call * calls if k == "flash_fwd" else 0 for k in got}):
        fail(f"int8 serving: {len(answered)} answered, repeats equal {first == second}, "
             f"launches {got} in {calls} calls (expected {per_call} flash_fwd each)")
    out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                    "prefill_s": st["prefill_s"], "decode_s": st["decode_s"]}
    del server
    torch.cuda.empty_cache()

    # (e) W8A8's products at the prefill's shapes (served: 8 x 896 decoder
    # tokens, 16 x 344 encoder tokens; fused projections)
    m_dec, m_enc = 8 * batch[0].shape[1], batch[2].shape[0] * batch[2].shape[1]
    w8 = [w8a8_case(torch, "decoder_qkv", m_dec, 1024, 4096, 141),
          w8a8_case(torch, "decoder_o", m_dec, 2048, 1024, 142),
          w8a8_case(torch, "decoder_gateup", m_dec, 1024, 6144, 143),
          w8a8_case(torch, "decoder_down", m_dec, 3072, 1024, 144),
          w8a8_case(torch, "encoder_qkv", m_enc, 1024, 3072, 145),
          w8a8_case(torch, "encoder_gateup", m_enc, 1024, 8192, 146),
          w8a8_case(torch, "encoder_down", m_enc, 4096, 1024, 147)]
    out["w8a8"] = w8
    # the int8 prefill's flash_fwd: Tk = P, not P + max_new
    rows = [kernel_case(torch, f"int8_prefill_B8_P{batch[0].shape[1]}", 8, batch[0].shape[1],
                        batch[0].shape[1], 16, 8, 128, True, 0, batch[1].to(torch.int32), 148)]

    # (f) the serving bench at the JAX bench's default (--frozen int8), and
    # with --kv int8 --fuse --w8a8
    benches = {}
    for label, extra in (("int8", []), ("all", ["--kv", "int8", "--fuse", "--w8a8"])):
        reset_counts()
        res = bench_serve.main(["--requests", str(CONT_REQUESTS), "--max_new",
                                str(CONT_MAX_NEW)] + extra)
        got = counts()
        torch.cuda.empty_cache()
        log(f"int8 bench [{card}] --frozen int8 {' '.join(extra)}: {res['value']:.1f} decoded "
            f"tokens/s ({res['decoded_tokens']} tokens, {res['requests']} requests over "
            f"{res['capacity']} slots in {res['seconds']:.2f} s; admit {res['admit_s']:.2f} s); "
            f"mean occupancy {res['mean_occupancy']:.3f}; {res['prefill_calls']} prefill "
            f"calls, {res['flash_fwd_per_prefill']:g} flash_fwd each; pools "
            f"{res['pool_gib']:.3f} GiB, weights {res['weights_gib']:.3f} GiB, "
            f"torch.cuda.max_memory_allocated {res['peak_gib']:.2f} GiB")
        if got != {k: (per_call * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
                   for k in got}:
            fail(f"the int8 bench launched {got}: expected {per_call} flash_fwd per prefill "
                 f"chunk (and its warmup's one) and nothing else")
        benches[label] = {**res, "launches": got["flash_fwd"]}
    out["bench"] = benches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"int8: phase done in {out['seconds']:.1f} s (budget {INT8_BUDGET_S:g})")
    if out["seconds"] > INT8_BUDGET_S:
        fail(f"the int8 phase took {out['seconds']:.1f} s, over {INT8_BUDGET_S:g}")
    return out, rows


# -- phase 15 ----------------------------------------------------------------

QWEN4B_LAYERS = 36                     # Qwen3-4B: 36 layers, 32/8 heads of 128
# cut for the script's time (from 3, 2 and 3)
QLORA_STEPS, QLORA_REPS = 4, 1         # bench_sft: 2 warm-up + 1 x 4 timed + 1 profiled
QLORA_GRPO_STEPS = 1                   # bench_grpo: 1 warm-up + 1 timed
QLORA_ROLLOUT_NEW, QLORA_ROLLOUT_REPS = 32, 1   # bench_rollout: 1 warm-up + 1 timed call
# (c) a QLoRA step against a bf16 model holding its dequantized weights: the
# int8 dense dequantizes in bf16 and calls the same GEMM on the same values,
# forward and backward, so on a deterministic route (the plain attention,
# remat on to bound its fp32 logits) the two are expected bitwise equal.
# Through the kernels flash_bwd's dq is reduce-added in no fixed order
# (ROADMAP 2): the int8 step against itself gives that route's noise floor,
# and the twin there is held to a cosine under the floor's readings and
# over the planted fault's (one decoder layer's dequantizing scale dropped
# from its down projection's backward)
QLORA_TWIN_LOSS_RTOL, QLORA_TWIN_COS, QLORA_KERNEL_COS = 1e-6, 0.999999, 0.999
# (e) the grouped int8-KV decode step against the ungrouped one on the same
# int8 caches: the same products summed in another order (bf16 operands
# with fp32 accumulation against fp32 einsums), whose bf16 outputs round
# apart through 28 layers. Held under the sound readings and over those of
# two planted faults of the grouped step's scales (`grouped_kv8_check`)
GROUPED_KV8_COS = 0.999
QLORA_BUDGET_S = 240.0


def dequantized_twin(torch, model, cfg):
    """A module tree holding `model`'s tensors except its int8 weights and
    expert banks, which it holds dequantized in their tower's compute dtype
    as frozen parameters (the values `dense` and `bank_product` compute
    from them): the adapters and the projection are the model's own."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.train.trainable import shared_copy
    from bioreason_tpu_torch.utils.devices import torch_dtype
    twin = shared_copy(model)
    with torch.no_grad():
        for tower, tcfg in ((twin.decoder, cfg.decoder), (twin.encoder, cfg.dna_tower)):
            for mod in tower.modules():
                if isinstance(mod, (torch.nn.Linear, L.ExpertBank)) and L.is_int8(mod):
                    w = L.int8_weight(mod, torch_dtype(tcfg.dtype))
                    del mod.weight, mod.scale
                    mod.weight = torch.nn.Parameter(w, requires_grad=False)
    return twin


def per_tensor_scale_backward(ctx, g):
    """A planted fault of `Int8Linear.backward`: dx dequantizes with one
    scale per weight (its channels' mean) in place of one per channel."""
    q, scale = ctx.saved_tensors
    dx = g.matmul(q.to(g.dtype) * scale.float().mean().to(g.dtype))
    db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[3] else None
    return dx, None, None, db


def qlora_twin_check(torch, trainer, batch):
    """(c): one QLoRA loss and its trainable gradients against the
    dequantized twin's, on the plain route (held bitwise-tight) and through
    the kernels (held to QLORA_KERNEL_COS, which the int8 step against
    itself must pass and a planted fault, `per_tensor_scale_backward`, must
    fail)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    db = trainer._device_batch(batch)
    cfg = trainer.fusion_cfg
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, attention_impl="xla", remat=True),
        encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"))
    real = trainer.model
    twin = dequantized_twin(torch, real, cfg)

    def loss_and_grad(model, c):
        trainer.model, trainer.fusion_cfg = model, c
        try:
            loss = trainer._loss(db, train=True)
            grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        finally:
            trainer.model, trainer.fusion_cfg = real, cfg
        return float(loss.detach()), torch.cat([
            (torch.zeros_like(p) if g is None else g).float().flatten()
            for p, g in zip(trainer.params, grads)])

    def compare(a, b):
        (la, ga), (lb, gb) = a, b
        return {"loss": la, "other_loss": lb, "loss_rel": abs(la - lb) / abs(lb),
                "grad_cos": float(F.cosine_similarity(ga, gb, dim=0)),
                "grad_max_abs_diff": float((ga - gb).abs().max()),
                "grad_max": float(gb.abs().max()), "bitwise": bool(torch.equal(ga, gb))}

    def show(what, r, n):
        log(f"qlora (c) {what}: loss {r['loss']:.7f} vs {r['other_loss']:.7f} (relative "
            f"{r['loss_rel']:.3g}); cosine of the {n} trainable gradients "
            f"{r['grad_cos']:.7f}, max abs diff {r['grad_max_abs_diff']:.3g} (max |g| "
            f"{r['grad_max']:.3g}); bitwise equal {r['bitwise']}")
    out = {}
    for route, c in (("plain", plain), ("kernels", cfg)):
        first = loss_and_grad(real, c)
        n = first[1].numel()
        out[route] = compare(first, loss_and_grad(twin, c))
        show(f"{route} route, the int8 step against a bf16 model holding its dequantized "
             f"weights", out[route], n)
        if route == "kernels":
            out["kernels_noise"] = compare(first, loss_and_grad(real, c))
            show("kernel route, the int8 step against itself (the noise floor)",
                 out["kernels_noise"], n)
            sound = L.Int8Linear.backward
            L.Int8Linear.backward = staticmethod(per_tensor_scale_backward)
            try:
                out["kernels_fault"] = compare(loss_and_grad(real, c), first)
            finally:
                L.Int8Linear.backward = sound
            show("kernel route, a planted fault (per-tensor scale in the int8 dense's "
                 "backward) against the int8 step", out["kernels_fault"], n)
        del first
    r, k = out["plain"], out["kernels"]
    noise, fault = out["kernels_noise"], out["kernels_fault"]
    log(f"qlora (c): held: the plain route's loss within {QLORA_TWIN_LOSS_RTOL} relative "
        f"and cosine >= {QLORA_TWIN_COS}; the kernel route's loss as tight and cosine >= "
        f"{QLORA_KERNEL_COS}, which its noise floor {noise['grad_cos']:.7f} must pass and "
        f"the fault {fault['grad_cos']:.7f} must fail")
    if (r["loss_rel"] > QLORA_TWIN_LOSS_RTOL or r["grad_cos"] < QLORA_TWIN_COS
            or not math.isfinite(r["loss"])):
        fail(f"QLoRA and its dequantized twin disagree on the plain route: {r}")
    if k["loss_rel"] > QLORA_TWIN_LOSS_RTOL or k["grad_cos"] < QLORA_KERNEL_COS:
        fail(f"QLoRA and its dequantized twin disagree through the kernels: {k}")
    if noise["grad_cos"] < QLORA_KERNEL_COS or fault["grad_cos"] >= QLORA_KERNEL_COS:
        fail(f"the kernel route's limit {QLORA_KERNEL_COS} does not part the noise floor "
             f"{noise['grad_cos']} from the planted fault {fault['grad_cos']}")
    del twin
    return out


GROUPED_KV8_FAULTS = {
    "the decode slot's scales dropped": lambda pk_s, pv_s, dk_s, dv_s: (pk_s, pv_s, None,
                                                                         None),
    "the prompt's key and value scales swapped": lambda pk_s, pv_s, dk_s, dv_s: (
        pv_s, pk_s, dk_s, dv_s)}


def grouped_kv8_check(torch, model, engine, inputs, group):
    """(e): the first decode step's fp32 logits of the grouped int8-KV
    decode (`decoder_decode_step_grouped`: the shared int8 prompt cache and
    an int8 decode slot) against the ungrouped int8-KV step
    (`decoder_forward` over the same prompt cache repeated G-fold plus the
    slot), on the engine's own prefill; then the grouped step again with
    each of GROUPED_KV8_FAULTS planted in `_grouped_decode_attention`'s
    scales, which the limit must catch."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import qwen3
    cfg = engine.cfg.decoder
    ids, mask, dna, dna_mask = (torch.as_tensor(a, device="cuda") for a in inputs)
    sound = qwen3._grouped_decode_attention
    with torch.inference_mode():
        last, pcache, _ = engine.prefill(model, ids, mask, dna, dna_mask, 0)
        b, p = ids.shape
        bg = b * group
        tok = last.argmax(-1).repeat_interleave(group)[:, None]
        pos = mask.sum(-1).repeat_interleave(group)[:, None]
        ones = torch.ones((bg, 1), dtype=torch.int32, device="cuda")

        def grouped():
            dcache = qwen3.init_cache(cfg, bg, 1, torch.bfloat16, "cuda", quantize=True)
            return qwen3.decoder_decode_step_grouped(model.decoder, cfg, tok, pos, pcache,
                                                     mask, dcache, 0, ones, group)[0][:, 0]
        lg = grouped()
        faulty = {}
        for name, fault in GROUPED_KV8_FAULTS.items():
            qwen3._grouped_decode_attention = (
                lambda *a, fault=fault: sound(*a[:8], *fault(*a[8:])))
            try:
                faulty[name] = grouped()
            finally:
                qwen3._grouped_decode_attention = sound
        ucache = [{k: torch.cat([v.repeat_interleave(group, 0),
                                 v.new_zeros((bg, 1) + tuple(v.shape[2:]))], 1)
                   for k, v in e.items()} for e in pcache]
        umask = torch.cat([mask.to(torch.int32).repeat_interleave(group, 0), ones], 1)
        lu, _ = qwen3.decoder_forward(model.decoder, cfg, input_ids=tok, attention_mask=ones,
                                      positions=pos, cache=ucache, cache_index=p,
                                      cache_mask=umask)
    lu = lu[:, 0]
    cos = float(F.cosine_similarity(lg, lu, dim=-1).min())
    agree = float((lg.argmax(-1) == lu.argmax(-1)).float().mean())
    err = float((lg - lu).abs().max())
    fault_cos = {name: float(F.cosine_similarity(f, lu, dim=-1).min())
                 for name, f in faulty.items()}
    log(f"qlora (e): grouped int8-KV decode vs the ungrouped int8-KV step, first step's "
        f"logits over {bg} rows (B={b} x G={group}, P={p}, {pcache[0]['k'].dtype} caches): "
        f"cosine min {cos:.7f} (>= {GROUPED_KV8_COS}), max abs diff {err:.4g} "
        f"(max |logit| {float(lu.abs().max()):.4g}), argmax agreement {agree:.3f}; planted "
        f"faults (must fall under {GROUPED_KV8_COS}): "
        + "; ".join(f"{name} {c:.7f}" for name, c in fault_cos.items()))
    if (cos < GROUPED_KV8_COS or not bool(torch.isfinite(lg).all())
            or pcache[0]["k"].dtype != torch.int8):
        fail(f"the grouped int8-KV decode differs from the ungrouped one: cosine {cos}")
    if max(fault_cos.values()) >= GROUPED_KV8_COS:
        fail(f"the limit {GROUPED_KV8_COS} misses a planted fault of the grouped int8-KV "
             f"decode: {fault_cos}")
    return {"cos_min": cos, "max_abs_diff": err, "argmax_agree": agree,
            "fault_cos_min": fault_cos}


def phase_qlora(torch, card):
    """QLoRA SFT and GRPO at NT-v2-500M + Qwen3-4B, the int8 rollouts and
    the grouped int8-KV decode (module docstring, phase 15)."""
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.tools import bench_grpo, bench_rollout, bench_sft
    t_phase = time.perf_counter()
    out, rows, bwd_rows = {"sft": {}, "rollout": {}}, [], []

    # (a)-(c) bench_sft at Qwen3-4B, int8 then bf16, each a main path:
    # counts from 0 just before, read just after
    per_step = {"flash_fwd": ENCODER_LAYERS + QWEN4B_LAYERS, "flash_bwd": QWEN4B_LAYERS}
    n_steps = 2 + QLORA_REPS * QLORA_STEPS + 1
    for frozen in ("int8", "bfloat16"):
        t_sub = time.perf_counter()
        reset_counts()
        res, trainer, batch = bench_sft.run(bench_sft.parse_args(
            ["--decoder", "qwen3-4b", "--frozen", frozen, "--steps", str(QLORA_STEPS),
             "--reps", str(QLORA_REPS)]))
        got = counts()
        log(f"qlora (a/b) bench_sft [{card}] --decoder qwen3-4b --frozen {frozen}: "
            f"{res['value']:.3f} examples/s (median of {res['repetitions']}), "
            f"{res['ms_per_step']:.1f} ms per step; profiled step busy "
            f"{res['profiled_step_busy_ms']:.2f} of {res['profiled_step_wall_ms']:.2f} ms; "
            f"resident frozen {res['resident_frozen_gib']:.3f} GiB, peak "
            f"{res['peak_gib']:.2f} GiB (init {res['init_peak_gib']:.2f}); "
            f"{res['trainable_params'] / 1e6:.2f} M trainable; loss {res['loss']:.4f}; "
            f"launches {got} over {n_steps} steps ({time.perf_counter() - t_sub:.1f} s)")
        want = {k: n_steps * per_step.get(k, 0) for k in got}
        if got != want or res["launches_per_step"] != per_step:
            fail(f"bench_sft --frozen {frozen} launched {got}, expected {want}")
        if not math.isfinite(res["loss"]):
            fail(f"bench_sft --frozen {frozen}: loss {res['loss']}")
        out["sft"][frozen] = {**res, "launches": got}
        if frozen == "int8":
            n8 = sum(1 for m in trainer.model.modules()
                     if isinstance(m, torch.nn.Linear) and L.is_int8(m))
            scales = {str(m.scale.dtype) for m in trainer.model.modules()
                      if isinstance(m, torch.nn.Linear) and L.is_int8(m)}
            log(f"qlora (a): {n8} int8 denses, scales {scales}")
            if n8 != 7 * (QWEN4B_LAYERS + ENCODER_LAYERS) or scales != {"torch.bfloat16"}:
                fail(f"QLoRA model: {n8} int8 denses, scales {scales}")
            out["twin"] = qlora_twin_check(torch, trainer, batch)
        del trainer, batch
        torch.cuda.empty_cache()
    i8, bf = out["sft"]["int8"], out["sft"]["bfloat16"]
    share = i8["resident_frozen_gib"] / bf["resident_frozen_gib"]
    log(f"qlora (b) [{card}]: int8's resident frozen bytes {share:.3f} of bf16's "
        f"({i8['resident_frozen_gib']:.3f} / {bf['resident_frozen_gib']:.3f} GiB); peaks "
        f"{i8['peak_gib']:.2f} (int8) vs {bf['peak_gib']:.2f} GiB (bf16); examples/s "
        f"{i8['value']:.3f} vs {bf['value']:.3f} ({i8['value'] / bf['value']:.3f}x)")
    if not i8["peak_gib"] < bf["peak_gib"] or not share < 0.6:
        fail(f"QLoRA's peak {i8['peak_gib']:.2f} GiB is not under bf16's "
             f"{bf['peak_gib']:.2f}, or its resident share is {share:.3f}")
    rows.append(kernel_case(torch, "qlora_sft_T768_4b", 4, 768, 768, 32, 8, 128, True, 0,
                            torch.ones((4, 768), dtype=torch.int32, device="cuda"), 151))
    bwd_rows.append(bwd_case(torch, "qlora_sft_T768_4b", 4, 768, 768, 32, 8, 128, True, 0,
                             torch.ones((4, 768), dtype=torch.int32, device="cuda"), 152))

    # (d) bench_grpo at Qwen3-4B, int8 frozen towers and int8 rollouts
    t_sub = time.perf_counter()
    reset_counts()
    res, trainer, items = bench_grpo.run(bench_grpo.parse_args(
        ["--decoder", "qwen3-4b", "--frozen", "int8", "--rollout_int8", "--new", str(GRPO_NEW),
         "--steps", str(QLORA_GRPO_STEPS), "--probe"]))
    got = counts()
    per_grpo = {"flash_fwd": 3 * ENCODER_LAYERS + 4 * QWEN4B_LAYERS, "flash_bwd": QWEN4B_LAYERS}
    want = {k: (1 + QLORA_GRPO_STEPS) * per_grpo.get(k, 0) for k in got}
    tm = res["timers"]
    log(f"qlora (d) bench_grpo [{card}] --decoder qwen3-4b --frozen int8 --rollout_int8: "
        f"{res['value']:.3f} completions/s, {res['seconds_per_step'] * 1e3:.1f} ms per step "
        f"({res['prompts']} prompts x G={res['G']}, P={res['prompt_len']}, {GRPO_NEW} new "
        f"tokens); seconds per phase "
        f"{', '.join(f'{k} {tm[k]:.3f}' for k in ('prep', 'rollout', 'logps_dispatch', 'rewards', 'update'))}; "
        f"peak {res['peak_gib']:.2f} GiB; loss {res['loss']:.6g} kl {res['kl']:.4g}; "
        f"launches {got} over {1 + QLORA_GRPO_STEPS} steps ({time.perf_counter() - t_sub:.1f} s)")
    if got != want:
        fail(f"bench_grpo launched {got}, expected {want}")
    if not (math.isfinite(res["loss"]) and math.isfinite(res["kl"])):
        fail(f"bench_grpo: loss {res['loss']}, kl {res['kl']}")
    model, ref, roll = trainer.model, trainer.ref_model, trainer.rollout_model()
    mods = {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear) and L.is_int8(m)}
    shared = {}
    for label, other in (("reference", ref), ("rollout", roll)):
        theirs = dict(other.named_modules())
        shared[label] = sum(theirs[n].weight.data_ptr() == m.weight.data_ptr()
                            and theirs[n].scale.data_ptr() == m.scale.data_ptr()
                            for n, m in mods.items())
    live = dict(model.named_parameters())
    adapters_live = all(p is live[n] for n, p in roll.named_parameters())
    log(f"qlora (d): the reference and the rollout policy share {shared['reference']} and "
        f"{shared['rollout']} of the training model's {len(mods)} int8 denses (weight and "
        f"scale data_ptr); the rollout's parameters are the model's own: {adapters_live}; its "
        f"embedding {roll.decoder.embed.weight.dtype} (the training model's "
        f"{model.decoder.embed.weight.dtype})")
    if (set(shared.values()) != {len(mods)} or not mods or not adapters_live
            or not L.is_int8(roll.decoder.embed)):
        fail(f"the GRPO models do not share the int8 storage: {shared} of {len(mods)}, "
             f"adapters live {adapters_live}")
    out["grpo"] = {**res, "launches": got, "shared": shared}
    r, b = grpo_kernel_cases(torch, trainer, items, prefix="qlora_grpo")
    rows += r
    bwd_rows += b
    del trainer, model, ref, roll, mods, live, items
    torch.cuda.empty_cache()

    # (e) bench_rollout at 16 x G=8, bf16 then int8 weights and KV, at the
    # bench's Qwen3-0.6B and at Qwen3-4B
    for decoder, layers in (("qwen3-0.6b", DECODER_LAYERS), ("qwen3-4b", QWEN4B_LAYERS)):
        for frozen in ("bfloat16", "int8"):
            t_sub = time.perf_counter()
            reset_counts()
            res, model, engine, inputs = bench_rollout.run(bench_rollout.parse_args(
                ["--decoder", decoder, "--frozen", frozen, "--kv", frozen, "--new",
                 str(QLORA_ROLLOUT_NEW), "--reps", str(QLORA_ROLLOUT_REPS)]))
            got = counts()
            want = {k: (1 + QLORA_ROLLOUT_REPS) * (ENCODER_LAYERS + layers)
                    if k == "flash_fwd" else 0 for k in got}
            log(f"qlora (e) bench_rollout [{card}] --decoder {decoder} --frozen {frozen} --kv "
                f"{frozen}: {res['value']:.1f} decoded tokens/s (median of "
                f"{[round(x, 1) for x in res['calls']]}), {res['rows']} rows x "
                f"{res['new_tokens']} tokens, P={res['prompt_len']}; last call prefill "
                f"{res['prefill_s'] * 1e3:.1f} ms, decode {res['decode_s'] * 1e3:.1f} ms; "
                f"weights {res['weights_gib']:.3f} GiB, peak {res['peak_gib']:.2f} GiB; "
                f"launches {got} ({time.perf_counter() - t_sub:.1f} s)")
            if got != want:
                fail(f"bench_rollout launched {got}, expected {want}")
            out["rollout"][f"{decoder}_{frozen}"] = {**res, "launches": got["flash_fwd"]}
            if decoder == "qwen3-0.6b" and frozen == "int8":
                out["grouped_kv8"] = grouped_kv8_check(torch, model, engine, inputs, res["G"])
            del model, engine
            torch.cuda.empty_cache()
        a, b = (out["rollout"][f"{decoder}_{f}"]["value"] for f in ("int8", "bfloat16"))
        log(f"qlora (e) [{card}] {decoder}: int8 weights + int8 KV {a:.1f} vs bf16 {b:.1f} "
            f"tokens/s ({a / b:.3f}x)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"qlora: phase done in {out['seconds']:.1f} s (budget {QLORA_BUDGET_S:g})")
    if out["seconds"] > QLORA_BUDGET_S:
        fail(f"the qlora phase took {out['seconds']:.1f} s, over {QLORA_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 16 -------------------------------------------------------------------

# the rehearsal's bench widths (Qwen3-0.6B + NT-v2-50M, 1-mer DNA of 32 bp),
# cut for time: 96 items (1,280 in the bench run), 2 SFT epochs of 9 steps
# (40 at most, with the probe's stop), a validation every 8 steps (96), 16
# tokens generated in the tests and rollouts (288; cut from 64), 1 GRPO step
# (80)
REH_ITEMS, REH_EPOCHS, REH_EVAL, REH_NEW, REH_GRPO = 96, 2, 8, 16, 1
REH_SEQ_LEN, REH_BATCH, REH_SEED = 32, 8, 7
REH_BUDGET_S = 150.0
# one SFT step: remat full runs every decoder layer's forward twice; the
# encoder's 32-wide heads take the plain path (models/attention.py)
REH_PER = {"train_step": {"flash_fwd": 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS},
           "eval_step": {"flash_fwd": DECODER_LAYERS},
           "generate": {"flash_fwd": DECODER_LAYERS},
           # the rollout's prefill, the reference logps, the update's forward
           # and its recompute
           "grpo_step": {"flash_fwd": 4 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}}
REH_DOTS_COS = 0.999                    # remat dots vs off through the kernels


class LaunchLog:
    """Each call of the wrapped functions with the kernel launches it made
    and its nesting depth (a rollout's engine call inside a GRPO step)."""

    def __init__(self):
        self.calls, self.depth, self._undo = [], 0, []

    def wrap(self, owner, attr, name):
        real = getattr(owner, attr)

        def wrapped(*a, **kw):
            before = counts()
            self.depth += 1
            try:
                return real(*a, **kw)
            finally:
                self.depth -= 1
                after = counts()
                self.calls.append((name, self.depth,
                                   {k: after[k] - before[k] for k in after if after[k] - before[k]}))
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, real))

    def close(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []


def jax_rule_kept(val_curve, k, stop_step):
    """The steps the JAX CLI's best-k keeps (cli/train_sft.py:280-323): a
    save only on a val loss 25% under the last kept one, and at the step the
    probe stops at; the k best of those saves."""
    kept, last = [], None

    def update(value, step):
        if len(kept) >= k and not value < kept[-1][0]:
            return False
        kept.append((value, step))
        kept.sort(key=lambda t: t[0])
        del kept[k:]
        return True
    for step, value in val_curve:
        if (last is None or value < 0.75 * last) and update(value, step):
            last = value
        if step == stop_step:
            update(value, step)
    return sorted(step for _, step in kept)


def rehearsal_fusion(torch):
    """The rehearsal's FusionConfig and processor (tools/rehearsal.py)."""
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    tok = ByteTextTokenizer()
    dec = DECODER_PRESETS["qwen3-0.6b"](vocab_size=tok.vocab_size)
    enc = ENCODER_PRESETS["nt-50m"]()
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=tok.dna_pad_id,
                       max_length_text=512, max_length_dna=REH_SEQ_LEN + 8)
    return cfg, tok, BioProcessor(tok, KmerTokenizer(kmer=1))


def phase_rehearsal(torch, card):
    """The quality rehearsal at its bench widths, cut for time (REH_*), and
    the training-loop pieces that came with it (module docstring, phase 16).
    Returns (numbers, forward rows, backward rows)."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.cli.common import load_items
    from bioreason_tpu_torch.data.collate import sft_collate
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.attention import attention
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.tools import bench_sft, rehearsal
    from bioreason_tpu_torch.train import eval as TE
    from bioreason_tpu_torch.train.checkpoint import TopKKeeper, load_checkpoint
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.sft import SFTTrainer
    from bioreason_tpu_torch.utils.debug_nans import nan_checks
    t_phase = time.perf_counter()
    out, rows, bwd_rows, stages = {}, [], [], {}
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_rehearsal_", dir=build_dir)
    try:
        # (a) the rehearsal tool, its launches counted per call of each kind
        art_path = os.path.join(work, "rehearsal_smoke.json")
        calls = LaunchLog()
        calls.wrap(SFTTrainer, "train_step", "train_step")
        calls.wrap(SFTTrainer, "eval_step", "eval_step")
        calls.wrap(TE, "teacher_forced_probe", "probe")
        calls.wrap(GenerationEngine, "generate", "generate")
        calls.wrap(GRPOTrainer, "step", "grpo_step")
        grpo_timers = []                      # the trainer's host timers by phase
        real_init = GRPOTrainer.__init__

        def init_with_timers(self, *a, **kw):
            real_init(self, *a, **kw)
            self.timers = {}
            grpo_timers.append(self.timers)
        GRPOTrainer.__init__ = init_with_timers
        t_sub = time.perf_counter()
        reset_counts()
        try:
            art = rehearsal.main(
                ["--scale", "bench", "--seq_len", str(REH_SEQ_LEN), "--items", str(REH_ITEMS),
                 "--sft_epochs", str(REH_EPOCHS), "--eval_every", str(REH_EVAL),
                 "--max_new", str(REH_NEW), "--grpo_steps", str(REH_GRPO),
                 "--seed", str(REH_SEED), "--work_dir", work, "--out", art_path])
        finally:
            calls.close()
            GRPOTrainer.__init__ = real_init
        total = counts()
        wall = time.perf_counter() - t_sub
        n_val = art["corpus"]["split"][1]
        probe_batches = -(-min(64, n_val) // REH_BATCH)
        want_per = {**REH_PER, "probe": {"flash_fwd": probe_batches * DECODER_LAYERS}}
        by_kind = {}
        for name, depth, delta in calls.calls:
            by_kind.setdefault(name, []).append(delta)
            if delta != want_per[name]:
                fail(f"rehearsal: a {name} call launched {delta}, expected {want_per[name]}")
        want_total = {}
        for name, depth, delta in calls.calls:
            if depth == 0:
                for k, v in delta.items():
                    want_total[k] = want_total.get(k, 0) + v
        got_total = {k: v for k, v in total.items() if v}
        n_calls = {k: len(v) for k, v in by_kind.items()}
        # the distinct launch counts measured per call of each kind
        per_call = {name: [dict(t) for t in sorted({tuple(sorted(d.items())) for d in ds})]
                    for name, ds in by_kind.items()}
        log(f"rehearsal (a) [{card}] tools/rehearsal.py --scale bench at {REH_ITEMS} items, "
            f"{REH_EPOCHS} epochs, eval every {REH_EVAL}, {REH_NEW} new tokens, {REH_GRPO} GRPO "
            f"steps: {wall:.1f} s (SFT {art['sft']['wall_s']} s, GRPO {art['grpo']['wall_s']} "
            f"s, tests {art['eval_wall_s']} s); calls {n_calls}; launches {got_total}, "
            f"per call {per_call} (reckoned {want_per}); GRPO seconds per phase over "
            f"{REH_GRPO} steps { {k: round(v, 3) for k, v in grpo_timers[0].items()} }; "
            f"test accuracy {art['test_accuracy_after_sft']:.4f} after "
            f"SFT, {art['test_accuracy_after_grpo']:.4f} after GRPO")
        if got_total != want_total or n_calls.get("train_step") != REH_EPOCHS * (
                art["corpus"]["split"][0] // REH_BATCH) or n_calls.get("grpo_step") != REH_GRPO:
            fail(f"rehearsal launched {got_total}, its calls {want_total} ({n_calls})")
        sft_logs = os.path.join(work, "sft_logs")
        val = rehearsal.load_curve(sft_logs, "val/loss")
        probes = {k: rehearsal.load_curve(sft_logs, f"val/probe_{k}")
                  for k in ("base_acc", "half_acc", "answer_acc", "span_acc")}
        reward = rehearsal.load_curve(os.path.join(work, "grpo_logs"), "grpo/reward")
        n_evals = n_calls["train_step"] // REH_EVAL
        log(f"rehearsal (a): val loss {[round(v, 4) for _, v in val]}, probe "
            f"{ {k: [round(x, 3) for _, x in c] for k, c in probes.items()} }, reward "
            f"{[round(x, 3) for _, x in reward]}")
        if (len(val) != n_evals or any(len(c) != n_evals for c in probes.values())
                or len(reward) != REH_GRPO or art["sft"]["val_loss_curve"] != val):
            fail(f"rehearsal: the metrics files lack curves ({len(val)} val, "
                 f"{ {k: len(c) for k, c in probes.items()} } probe, {len(reward)} reward)")
        if not min(v for _, v in val[1:]) < val[0][1]:
            fail(f"rehearsal: the val loss never fell below its first reading {val}")
        keeper = TopKKeeper(os.path.join(work, "sft_ckpt", "best"), k=2)
        kept = sorted(step for _, step, _ in keeper._kept)
        stop = n_calls["train_step"] if n_calls["train_step"] < REH_EPOCHS * (
            art["corpus"]["split"][0] // REH_BATCH) else None
        want_kept = jax_rule_kept(val, 2, stop)
        lean = [("opt_state" not in torch.load(os.path.join(path, "state.pt"), mmap=True,
                                               map_location="cpu", weights_only=True))
                for _, _, path in keeper._kept]
        log(f"rehearsal (a): best-k kept steps {kept} (the JAX rule on this val curve: "
            f"{want_kept}), params only {lean}; artifact {art_path} (default "
            f"{rehearsal.default_out('bench')})")
        if kept != want_kept or not all(lean) or not lean:
            fail(f"rehearsal: best-k kept {kept} (params only {lean}), the JAX rule {want_kept}")
        pkg = os.path.join(REPO, "bioreason_tpu_torch")
        default = rehearsal.default_out("bench")
        if (not os.path.isfile(art_path) or not art_path.startswith(pkg + os.sep)
                or os.path.dirname(default) != os.path.join(pkg, "artifacts")):
            fail(f"rehearsal: artifact {art_path}, default {default}: not under {pkg}")
        g = torch.Generator(device="cuda").manual_seed(5)
        q32 = torch.randn((2, 64, 16, 32), generator=g, device="cuda").to(torch.bfloat16)
        try:
            attention(q32, q32, q32, impl="pallas")
            fail("attention(impl='pallas') at D = 32 on the card did not raise")
        except ValueError as e:
            log(f"rehearsal (a): attention(impl='pallas') at D = 32 raises: {e}")
        out["a"] = {"wall_s": wall, "launches": got_total, "calls": n_calls,
                    "per_call": per_call, "grpo_timers": grpo_timers[0], "val_loss": val, "kept": kept,
                    "acc_sft": art["test_accuracy_after_sft"],
                    "acc_grpo": art["test_accuracy_after_grpo"]}

        stages["a"] = round(time.perf_counter() - t_phase, 1)

        # (f) the kernels at the rehearsal's decoder shape: a training batch
        items = load_items("kegg", os.path.join(work, "corpus"), 0, 0, REH_SEED)[0][:REH_BATCH]
        cfg, tok, proc = rehearsal_fusion(torch)
        batch = sft_collate(items, proc, 512, REH_SEQ_LEN + 8, bucket=128, supervise_eos=True)
        mask = torch.as_tensor(np.asarray(batch["attention_mask"]), device="cuda").to(torch.int32)
        t_dec = mask.shape[1]
        rows.append(kernel_case(torch, f"rehearsal_sft_T{t_dec}", REH_BATCH, t_dec, t_dec, 16, 8,
                                128, True, 0, mask, 161))
        bwd_rows.append(bwd_case(torch, f"rehearsal_sft_T{t_dec}", REH_BATCH, t_dec, t_dec, 16, 8,
                                 128, True, 0, mask, 162))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stages["f"] = round(time.perf_counter() - t_phase - sum(stages.values()), 1)

    # (c) bench_sft at bench.py's shape, remat off, full and dots
    t_sub = time.perf_counter()
    out["c"] = {}
    per_off = {"flash_fwd": ENCODER_LAYERS + DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
    per_on = {"flash_fwd": ENCODER_LAYERS + 2 * DECODER_LAYERS, "flash_bwd": DECODER_LAYERS}
    for remat in ("off", "full", "dots"):
        reset_counts()
        res, trainer, batch = bench_sft.run(bench_sft.parse_args(
            ["--remat", remat, "--steps", "2", "--reps", "1"]))
        want = per_off if remat == "off" else per_on
        if res["launches_per_step"] != want:
            fail(f"bench_sft --remat {remat} launched {res['launches_per_step']} a step, "
                 f"expected {want}")
        out["c"][remat] = {"examples_per_sec": res["value"], "peak_gib": res["peak_gib"],
                           "ms_per_step": res["ms_per_step"],
                           "busy_ms": res["profiled_step_busy_ms"],
                           "wall_ms": res["profiled_step_wall_ms"]}
        if remat != "off":
            del trainer, batch
            torch.cuda.empty_cache()
            continue
        db = trainer._device_batch(batch)
        cfg0 = trainer.fusion_cfg

        def loss_and_grad(remat_on, policy="full"):
            trainer.fusion_cfg = dataclasses.replace(
                cfg0, decoder=dataclasses.replace(cfg0.decoder, remat=remat_on,
                                                  remat_policy=policy))
            try:
                loss = trainer._loss(db, train=True)
                grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
            finally:
                trainer.fusion_cfg = cfg0
            return float(loss.detach()), torch.cat([
                (torch.zeros_like(p) if g is None else g).float().flatten()
                for p, g in zip(trainer.params, grads)])
        l_off, g_off = loss_and_grad(False)
        l_again, g_again = loss_and_grad(False)
        l_dots, g_dots = loss_and_grad(True, "dots")
        floor = float(F.cosine_similarity(g_off, g_again, dim=0))
        cos = float(F.cosine_similarity(g_off, g_dots, dim=0))
        out["c"]["dots_vs_off"] = {"loss": [l_off, l_dots], "cos": cos, "off_vs_off_cos": floor}
        log(f"rehearsal (c): one step at bench.py's shape, remat dots vs off: loss {l_dots!r} vs "
            f"{l_off!r}, cosine of the {g_off.numel()} trainable gradients {cos:.7f} (off "
            f"against itself {floor:.7f}: flash_bwd's dq sums in no fixed order)")
        if l_dots != l_off or cos < REH_DOTS_COS:
            fail(f"remat dots against off: loss {l_dots} vs {l_off}, cosine {cos:.6f}")
        del g_off, g_again, g_dots

        # (d) an async save during training
        ckdir = tempfile.mkdtemp(prefix="smoke_async_", dir=build_dir)
        try:
            plain = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                plain.append(time.perf_counter() - t0)
            snap = {k: v.detach().clone() for k, v in trainer.trainable_state().items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.save(os.path.join(ckdir, "s"), block=False)
            trainer.train_step(batch)
            torch.cuda.synchronize()
            around = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer.finish_saves()
            wait = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.save(os.path.join(ckdir, "b"), block=True)
            blocking_call = time.perf_counter() - t0
            trainer.train_step(batch)
            torch.cuda.synchronize()
            around_blocking = time.perf_counter() - t0
            state = load_checkpoint(os.path.join(ckdir, "s"))
            same = all(torch.equal(state["trainable"][k], v.cpu()) for k, v in snap.items())
            moved = sum(not torch.equal(trainer.trainable_state()[k].detach(), v)
                        for k, v in snap.items())
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        out["d"] = {"plain_step_s": plain, "step_around_save_s": around,
                    "wait_after_s": wait, "blocking_save_s": blocking_call,
                    "step_around_blocking_save_s": around_blocking}
        log(f"rehearsal (d) [{card}]: a step around save(block=False) {around * 1e3:.1f} ms "
            f"(then {wait * 1e3:.1f} ms waiting for the write), around a blocking save "
            f"{around_blocking * 1e3:.1f} ms (the save {blocking_call * 1e3:.1f} ms), "
            f"plain steps {[round(x * 1e3, 1) for x in plain]} ms; the file holds the "
            f"snapshot's {len(snap)} tensors: {same}; {moved} moved since")
        if not same or not moved:
            fail(f"the async save holds other values than its snapshot ({same}, {moved})")
        del trainer, batch, db, snap, state
        torch.cuda.empty_cache()
    log(f"rehearsal (c) [{card}] bench_sft at bench.py's shape: "
        f"{ {k: v for k, v in out['c'].items() if k != 'dots_vs_off'} } "
        f"({time.perf_counter() - t_sub:.1f} s)")
    stages["c_d"] = round(time.perf_counter() - t_phase - sum(stages.values()), 1)

    # (e) --debug_nans: a NaN out of the flash kernel and out of an aten op
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((1, 128, 2, 64), generator=g, device="cuda").to(torch.bfloat16)
    bad = q.clone()
    bad[0, 3, 1, 5] = float("nan")
    raised = []
    with nan_checks():
        fa.flash_attention(q, q, q, causal=True)               # sound: no raise
        for fn in (lambda: fa.flash_attention(bad, q, q, causal=True),
                   lambda: q.float() * float("nan")):
            try:
                fn()
                fail("--debug_nans: a planted NaN did not raise")
            except FloatingPointError as e:
                raised.append(str(e))
    log(f"rehearsal (e): --debug_nans raised {raised}")
    out["seconds"] = time.perf_counter() - t_phase
    stages["e"] = round(out["seconds"] - sum(stages.values()), 1)
    out["stages"] = stages
    log(f"rehearsal: phase done in {out['seconds']:.1f} s (budget {REH_BUDGET_S:g}); seconds "
        f"by stage {stages}")
    if out["seconds"] > REH_BUDGET_S:
        fail(f"the rehearsal phase took {out['seconds']:.1f} s, over {REH_BUDGET_S:g}")
    return out, rows, bwd_rows


# -- phase 17 -------------------------------------------------------------------

# Qwen3-30B-A3B (config.py:qwen3_30b_a3b) with NT-v2-500M, at full width and
# depth, bf16 weights drawn from seed 0 on the card
MOE_LAYERS = 48
MOE_BUDGET_S = 180.0
MOE_NEW = 32                            # served new tokens (cut from phase 4's 64)
MOE_GROUP_NEW = 16                      # (d)'s grouped completions
MOE_BENCH_NEW = 32                      # (e)'s longest completion (bench: 128; cut from 64)
# (c) kernel vs plain route, last-column prefill logits of one request: the
# two attention routes round apart (bf16 P against fp32), which can move a
# near-tie of the router in some layer and send a token to another expert
MOE_ROUTE_COS = 0.99
# (c) one MoE layer in bf16 against fp32 on the served prefill's input: the
# tokens routed alike (the same k experts, the same drops) must share at
# least this share, and agree to this cosine (bf16 products, fp32 sums)
MOE_ALIKE_SHARE, MOE_LAYER_COS = 0.8, 0.99
# (f) --int8 against bf16, teacher-forced: phase 14's floor. On an NVIDIA
# H100 80GB HBM3 at 700.00 W the sound int8 banks read a minimum of
# 0.993968, one scale per bank (the mean) 0.990700 and one scale per bank
# (the largest) 0.234760: a mild fault of the scale layout moves random
# weights' logits too little for a cosine to see, so the banks are also
# held to their own bound: the largest error of the dequantized bank
# against the bf16 one it was quantized from, in quantization steps
# (absmax over the input axis / 127), is half a step for a per-(expert,
# out-channel) store, plus fp32 rounding (read 0.500002; the faults 59.8
# and 210.2). Every planted fault must break that bound, and one must read
# under the floor
MOE_INT8_COS_FLOOR, MOE_BANK_STEPS = 0.98, 0.501
MOE_BANK_LAYERS = (0, MOE_LAYERS - 1)    # the banks kept in bf16 for the bound
MOE_BANK_FAULTS = {
    "one scale per bank, its scales' mean":
        lambda sc: sc.float().mean().to(sc.dtype).expand_as(sc),
    "one scale per bank, its largest (a per-tensor absmax)": lambda sc: sc.amax().expand_as(sc)}
MOE_INT8_NEW = 16


def moe_config():
    """(FusionConfig, BioProcessor) of Qwen3-30B-A3B + NT-v2-500M with the
    byte tokenizer, as `serve.build_config` makes the presets' pairs (no CLI
    preset names a MoE decoder, as in the JAX package)."""
    from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, FusionConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    tok = ByteTextTokenizer()
    cfg = FusionConfig(decoder=DecoderConfig.qwen3_30b_a3b(), encoder=EncoderConfig.nt_v2_500m(),
                       dna_pad_token_id=tok.dna_pad_id, max_length_dna=2048)
    return cfg, BioProcessor(tok, KmerTokenizer())


class MoeRecorder:
    """Wraps `layers.moe_apply` and `layers.moe_slots` (which `moe_apply`
    calls once) to record each MoE call's module (`id`), rows `n`,
    capacity `cap` and its experts `idx`, slots `slot` and keep flags
    `keep` [N, k] on the device (no host sync), and with `keep_input` the
    first call's module and input; `close` restores them."""

    def __init__(self, keep_input=False):
        from bioreason_tpu_torch.models import layers as L
        self.L, self.calls, self.inputs, self.module = L, [], [], None
        self.real_slots, self.real_apply = L.moe_slots, L.moe_apply

        def slots(idx, e, cap):
            slot, keep = self.real_slots(idx, e, cap)
            self.calls.append({"module": self.module, "n": idx.shape[0], "cap": cap,
                               "idx": idx, "slot": slot, "keep": keep})
            return slot, keep

        def apply(moe, x, *a, **kw):
            self.module = id(moe)
            if keep_input and not self.inputs:
                self.inputs.append((moe, x.detach().clone(), a, kw))
            return self.real_apply(moe, x, *a, **kw)
        L.moe_slots, L.moe_apply = slots, apply

    def close(self):
        self.L.moe_slots, self.L.moe_apply = self.real_slots, self.real_apply


def moe_kept_numel(torch, fn):
    """fn() under a dispatch mode that records the largest tensor any op
    allocates (outputs that share an input's storage, as views do, are not
    allocations): the index form allocates nothing of N * E * C elements."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def storages(xs):
        return {t.untyped_storage().data_ptr() for t in xs if isinstance(t, torch.Tensor)}

    class MaxNumel(TorchDispatchMode):
        biggest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            given = storages([*args, *(kwargs or {}).values()])
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in given:
                    MaxNumel.biggest = max(MaxNumel.biggest, t.numel())
            return out
    with MaxNumel():
        out = fn()
    return out, MaxNumel.biggest


def moe_layer_check(torch, card, moe, x, cfg):
    """(c): one MoE layer's output in bf16 against the port's fp32
    `moe_apply` on the same input (the served prefill's first layer), and
    the largest tensor the bf16 call allocates."""
    import torch.nn.functional as F
    from bioreason_tpu_torch.models import layers as L
    dec = cfg.decoder
    k, e = dec.num_experts_per_tok, dec.num_experts
    n = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(n, e, k, dec.moe_capacity_factor)
    with torch.inference_mode():
        y16, biggest = moe_kept_numel(torch, lambda: L.moe_apply(
            moe, x, k, dec.norm_topk_prob, torch.bfloat16, dec.moe_capacity_factor))
        y32 = L.moe_apply(moe, x.float(), k, dec.norm_topk_prob, torch.float32,
                          dec.moe_capacity_factor)
        routes = []
        for dtype, xx in ((torch.bfloat16, x), (torch.float32, x.float())):
            xf = xx.reshape(n, -1).to(dtype)
            _, idx = L.moe_route(moe, xf, k, dec.norm_topk_prob, dtype)
            _, keep = L.moe_slots(idx, e, cap)
            routes.append(torch.where(keep, idx, -1).sort(-1).values)
    alike = (routes[0] == routes[1]).all(-1)
    a, b = y16.reshape(n, -1).float(), y32.reshape(n, -1)
    zero = (b.abs().sum(-1) == 0)
    live = alike & ~zero
    cos = F.cosine_similarity(a[live], b[live], dim=-1)
    share = float(alike.float().mean())
    log(f"moe layer [{card}] bf16 vs fp32 moe_apply at the served prefill's N = {n} "
        f"(C = {cap}): {share:.4f} of tokens routed alike (>= {MOE_ALIKE_SHARE}); on those "
        f"cosine min {float(cos.min()):.6f}, median {float(cos.median()):.6f} (>= "
        f"{MOE_LAYER_COS}); rows dropped whole alike in both "
        f"{bool((zero[alike] == (a.abs().sum(-1) == 0)[alike]).all())}; largest tensor of the "
        f"bf16 call {biggest:,} elements (the [E * C, H] buffer is {e * cap * x.shape[-1]:,}) "
        f"against N * E * C = {n * e * cap:,}")
    if share < MOE_ALIKE_SHARE or float(cos.min()) < MOE_LAYER_COS:
        fail(f"the bf16 MoE layer disagrees with fp32: share {share:.4f}, cosine "
             f"{float(cos.min()):.6f}")
    if biggest >= n * e * cap // 2:
        fail(f"moe_apply allocated {biggest:,} elements, not the index form")
    return {"alike_share": share, "cos_min": float(cos.min()), "largest_numel": biggest,
            "n_e_c": n * e * cap}


def moe_drops(torch, calls, pad_rows=None):
    """Per recorded MoE call: (token, choice) pairs dropped, tokens with a
    drop, and of those the pads (rows where `pad_rows` [N] is True)."""
    out = []
    for c in calls:
        lost = ~c["keep"]
        tok = lost.any(-1)
        pads = int((tok & pad_rows).sum()) if pad_rows is not None else None
        out.append({"n": c["n"], "cap": c["cap"], "pairs": int(lost.sum()),
                    "tokens": int(tok.sum()), "pad_tokens": pads})
    return out


def moe_slots_check(torch, card, calls, num_experts, pad_rows, x):
    """(c): each recorded call's slots and keep flags recomputed as the JAX
    package computes them (layers.py:258-264: a cumulative sum down the
    tokens of the [N, E] one-hot in fp32) and held equal to `moe_slots`'s;
    the experts' loads (tokens routed to each, before the capacity), the
    experts the left pads picked, and the mean cosine between the first
    layer's input rows `x` (the router's input), real tokens and all."""
    import torch.nn.functional as F
    loads, bad = [], []
    for li, c in enumerate(calls):
        assign = F.one_hot(c["idx"], num_experts).sum(1).float()        # [N, E]
        pos = assign.cumsum(0) - 1.0
        keep = assign * (pos < c["cap"])
        mine = torch.zeros_like(assign).scatter_(1, c["idx"], c["keep"].float())
        if not (torch.equal(keep, mine)
                and torch.equal(pos.gather(1, c["idx"]).to(torch.int32), c["slot"])):
            bad.append(li)
        loads.append(assign.sum(0))
    loads = torch.stack(loads).to(torch.int64).cpu()                    # [layers, E]
    cap = calls[0]["cap"]
    top = loads.sort(-1, descending=True).values
    pad_experts = sorted(int(e) for e in torch.unique(calls[0]["idx"][pad_rows]))
    xn = F.normalize(x.reshape(-1, x.shape[-1]).float(), dim=-1)

    def mean_cos(rows):
        m = rows.shape[0]
        return float((rows.sum(0).square().sum() - m) / (m * (m - 1)))
    cos_all, cos_real = mean_cos(xn), mean_cos(xn[~pad_rows])
    over = (loads > cap).sum(-1)
    log(f"moe slots [{card}]: keep and slot of {len(calls)} served-prefill layers against the "
        f"JAX form (cumsum over the [N, E] one-hot): equal in {len(calls) - len(bad)} "
        f"(unequal in layers {bad})")
    log(f"moe loads [{card}] served prefill, tokens routed per expert before the capacity "
        f"(C = {cap}, N * k / E = {calls[0]['n'] * calls[0]['idx'].shape[1] / num_experts:g}): "
        f"layer 0's 16 largest {top[0, :16].tolist()}, its median {int(top[0].median())}, "
        f"experts with no token {int((loads[0] == 0).sum())}; the largest per layer "
        f"{top[:, 0].tolist()}; experts over C per layer {over.tolist()}; the pads' experts in "
        f"layer 0 {pad_experts} with loads {[int(loads[0, e]) for e in pad_experts]}; mean "
        f"cosine between layer 0's router inputs: all rows {cos_all:.4f}, real tokens "
        f"{cos_real:.4f}")
    if bad:
        fail(f"moe_slots disagrees with the JAX form in layers {bad}")
    return {"layers_equal": len(calls) - len(bad), "loads_max": top[:, 0].tolist(),
            "experts_over_cap": over.tolist(), "load_layer0": loads[0].tolist(),
            "pad_experts": pad_experts, "router_input_mean_cos": {"all": cos_all,
                                                                  "real": cos_real}}


def moe_profile(torch, card, model, cfg, batch, label):
    """One prefill and one decode step of the served batch under the
    profiler, the MoE split by part: router and top-k, slots, dispatch
    gather, expert bmm, combine; attention; the rest (busy minus those)."""
    from torch.profiler import record_function
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.models import qwen3 as Q
    parts = {"moe_route": "router + top-k", "moe_slots": "slots",
             "moe_dispatch": "dispatch gather", "moe_experts": "expert bmm",
             "moe_combine": "combine"}
    real = {name: getattr(L, name) for name in parts}
    real_attn = Q.attention

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    for name, fn in real.items():
        setattr(L, name, labelled(name, fn))
    Q.attention = labelled("attention", real_attn)
    engine = GenerationEngine(cfg, eos_token_id=-1)
    ids, mask, dna, dmask = batch
    b, p = ids.shape
    out = {}
    try:
        with torch.inference_mode():
            engine.prefill(model, *batch, 2)
            busy, wall, got, kern = profile_step(
                torch, card, f"{label} prefill", lambda: engine.prefill(model, *batch, 2),
                ("flash_fwd", "nvjet", "gemm"), ranges=(*parts, "attention"))
            # the flash kernel is launched through ctypes, outside any torch
            # op, so its time joins the attention range by name
            flash = sum(d for name, d, *_ in kern if "flash_fwd" in name) / 1e6
            out["prefill"] = {"busy_ms": busy, "wall_ms": wall, "launches": len(kern),
                              "parts": {k: v[1] + (flash if k == "attention" else 0.0)
                                        for k, v in got.items()}}
            _, cache, cmask = engine.prefill(model, *batch, 2)
            cmask[:, p] = 1
            tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
            pos = mask.sum(-1)[:, None]
            ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")

            def step():
                return Q.decoder_forward(model.decoder, cfg.decoder, input_ids=tok,
                                         attention_mask=ones, positions=pos, cache=cache,
                                         cache_index=p, cache_mask=cmask)
            step()
            busy, wall, got, kern = profile_step(torch, card, f"{label} decode step", step,
                                                 ("nvjet", "gemm"),
                                                 ranges=(*parts, "attention"))
            out["decode"] = {"busy_ms": busy, "wall_ms": wall, "launches": len(kern),
                             "parts": {k: v[1] for k, v in got.items()}}
    finally:
        for name, fn in real.items():
            setattr(L, name, fn)
        Q.attention = real_attn
    for what, r in out.items():
        rest = r["busy_ms"] - sum(r["parts"].values())
        log(f"moe profile [{card}] {label} {what}: device busy {r['busy_ms']:.3f} of "
            f"{r['wall_ms']:.3f} ms wall ({100 * r['busy_ms'] / max(r['wall_ms'], 1e-9):.1f}%), "
            f"{r['launches']} launches; "
            + ", ".join(f"{parts.get(k, k)} {v:.3f} ms ({100 * v / max(r['busy_ms'], 1e-9):.1f}%)"
                        for k, v in r["parts"].items())
            + f", the rest {rest:.3f} ms ({100 * rest / max(r['busy_ms'], 1e-9):.1f}%)")
        r["rest_ms"] = rest
    return out


@contextlib.contextmanager
def moe_bank_scale_fault(torch, model, fault):
    """A planted fault of the int8 expert banks (f): every bank of the
    decoder dequantizes with `fault`(its [E, 1, out] scales) in their
    place; restored on exit."""
    from bioreason_tpu_torch.models import layers as L
    banks = [m for m in model.decoder.modules() if isinstance(m, L.ExpertBank)]
    saved = [m.scale for m in banks]
    try:
        for m, sc in zip(banks, saved):
            m.scale = fault(sc)
        yield
    finally:
        for m, sc in zip(banks, saved):
            m.scale = sc


def moe_bank_steps(torch, model, kept):
    """(f): the largest error of the int8 banks of the layers in `kept`
    ({layer: {name: its bf16 bank, kept before quantizing}}), dequantized
    as `moe_experts` dequantizes them (`layers.expert_bank`, here in fp32),
    against those bf16 banks, in quantization steps (absmax over the input
    axis / 127, from the bf16 bank)."""
    from bioreason_tpu_torch.models import layers as L
    worst = 0.0
    for li, banks in kept.items():
        experts = model.decoder.layers[li].mlp.experts
        for name, w in banks.items():
            w = w.float()
            step = (w.abs().amax(-2, keepdim=True) / 127.0).clamp(min=1e-12)
            err = (L.expert_bank(getattr(experts, name), torch.float32) - w).abs_().div_(step)
            worst = max(worst, float(err.amax()))
            del w, step, err
    return worst


def moe_expert_bound(cfg, n_rows, kept_pairs, label):
    """The expert products' bound over the decoder: FLOPs / 989e12 against
    bytes / 3.35e12, for the capacity form as it computes (E * C rows, every
    bank read) and for what this run's data needs (the kept (token, expert)
    pairs, the banks of the experts some token picked: `kept_pairs` and
    `picked` per layer)."""
    from bioreason_tpu_torch.models import layers as L
    dec = cfg.decoder
    h, i, e, k = dec.hidden_size, dec.moe_intermediate_size, dec.num_experts, \
        dec.num_experts_per_tok
    cap = L.moe_capacity(n_rows, e, k, dec.moe_capacity_factor)
    flops_form = 6.0 * e * cap * h * i * dec.num_layers
    bytes_form = (3 * e * h * i * 2 + 2 * 2 * e * cap * h) * dec.num_layers
    pairs, picked = kept_pairs
    flops_need = 6.0 * h * i * sum(pairs)
    bytes_need = sum(3 * pk * h * i * 2 + 2 * 2 * pr * h for pr, pk in zip(pairs, picked))
    res = {}
    for what, f, nb in (("capacity form", flops_form, bytes_form), ("needed", flops_need,
                                                                     bytes_need)):
        t_ops, t_bytes = f / PEAK_BF16_FLOPS * 1e3, nb / PEAK_HBM_BYTES * 1e3
        res[what] = {"tflop": f / 1e12, "gib": nb / 2 ** 30, "ops_ms": t_ops,
                     "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"moe expert products {label} (N = {n_rows}, C = {cap}, 48 layers): "
        + "; ".join(f"{w}: {r['tflop']:.3f} TFLOP / 989e12 = {r['ops_ms']:.3f} ms against "
                    f"{r['gib']:.2f} GiB / 3.35e12 = {r['bytes_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.3f} ms ({r['bound_by']})" for w, r in res.items()))
    return res


def phase_moe(torch, card):
    """Qwen3-MoE serving at Qwen3-30B-A3B + NT-v2-500M (module docstring,
    phase 17)."""
    import gc

    import torch.nn.functional as F
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.models.qwen3 import decoder_forward
    from bioreason_tpu_torch.serve import InferenceServer, prepare_batch, serving_storage
    from bioreason_tpu_torch.tools import bench_serve
    from bioreason_tpu_torch.train.quant import storage_bytes
    t_phase = time.perf_counter()
    per_call = ENCODER_LAYERS + MOE_LAYERS
    out = {}

    # (a) build: nothing of the earlier phases left, then the model in bf16
    # directly on the card (an fp32 stage would need 114 GiB)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"moe: {left / 2**30:.3f} GiB allocated before the build")
    if left > 2 * 2**30:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                       for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)
        fail(f"{left / 2**30:.2f} GiB of earlier phases is still allocated; the largest live "
             f"CUDA tensors {live[:10]}")
    cfg, processor = moe_config()
    dec = cfg.decoder
    if (dec.num_layers, dec.hidden_size, dec.num_heads, dec.num_kv_heads, dec.head_dim,
            dec.num_experts, dec.num_experts_per_tok, dec.moe_intermediate_size,
            dec.tie_word_embeddings, dec.vocab_size) != (MOE_LAYERS, 2048, 32, 4, 128, 128, 8,
                                                         768, False, 151936):
        fail(f"the decoder is not at Qwen3-30B-A3B width: {dec}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_fusion(cfg, seed=0, device="cuda").requires_grad_(False)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    n_all = sum(p.numel() for p in model.parameters())
    resident = storage_bytes(model)
    log(f"moe [{card}]: Qwen3-30B-A3B ({n_dec / 1e9:.3f} B parameters: {dec.num_layers} layers, "
        f"hidden {dec.hidden_size}, {dec.num_heads}/{dec.num_kv_heads} heads of {dec.head_dim}, "
        f"{dec.num_experts} experts of {dec.moe_intermediate_size}, {dec.num_experts_per_tok} "
        f"active, tied head {dec.tie_word_embeddings}, vocab {dec.vocab_size:,}) + NT-v2-500M, "
        f"{n_all / 1e9:.3f} B in all, {dec.dtype} on the card: {resident / 2**30:.2f} GiB "
        f"resident, built in {t_build:.2f} s; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out["build"] = {"params": n_all, "decoder_params": n_dec, "gib": resident / 2**30,
                    "s": t_build}

    items, padded = served_inputs()
    batch = [torch.as_tensor(a, device="cuda") for a in padded]
    b, p = batch[0].shape

    # (b) serve: the micro-batch server, 8 concurrent 2 kb requests twice;
    # the main path, counts from 0 just before and read just after
    server = InferenceServer(model, cfg, processor, max_batch=8, batch_window_ms=500.0,
                             max_new_tokens=MOE_NEW, greedy_default=True)
    server.start()
    calls_out, restore = record_engine_calls(server)
    reset_counts()
    calls0 = server.engine_calls
    try:
        first = burst(server, items, MOE_NEW)
        second = burst(server, items, MOE_NEW)
    finally:
        server.stop()
        restore()
    got = counts()
    calls = server.engine_calls - calls0
    answered = [r for r in first + second if r and set(r) == {"completion", "answer"}]
    # the prefill alone: all of an engine call's launches, so its decode
    # steps launched none
    reset_counts()
    recorder = MoeRecorder(keep_input=True)
    try:
        with torch.inference_mode():
            server.engine.prefill(model, *batch, MOE_NEW)
        torch.cuda.synchronize()
    finally:
        recorder.close()
    prefill_launches = counts()
    st = [s for _, s in calls_out]
    log(f"moe serve [{card}]: {len(answered)} requests answered in {calls} engine calls "
        f"(batches {[s['batch'] for s in st]}), launches {got} = "
        f"{got['flash_fwd'] / max(calls, 1):g} flash_fwd per engine call; one prefill alone "
        f"{prefill_launches}, so 0 in each call's {st[-1]['steps'] - 1} decode steps")
    for name, s in (("first 8", st[0]), ("same 8 again", st[-1])):
        log(f"moe serve [{card}] {name}: B={s['batch']} P={s['prompt_len']}: prefill "
            f"{s['prefill_s'] * 1e3:.1f} ms; decode "
            f"{s['decode_tokens'] / max(s['decode_s'], 1e-9):.1f} tokens/s over "
            f"{s['steps'] - 1} steps ({s['decode_s'] / max(s['steps'] - 1, 1) * 1e3:.2f} ms "
            f"per step)")
    if (len(answered) != 16 or first != second or calls != 2
            or got != {k: per_call * calls if k == "flash_fwd" else 0 for k in got}
            or prefill_launches["flash_fwd"] != per_call):
        fail(f"moe serving: {len(answered)} answered, repeats equal {first == second}, "
             f"launches {got} in {calls} calls, {prefill_launches} in one prefill (expected "
             f"{per_call} flash_fwd per call, all in its prefill)")
    if server.engine.nonfinite_rows:
        fail(f"moe serving: {server.engine.nonfinite_rows} logit rows were not finite")
    per_engine_call = got["flash_fwd"] / calls
    out["serve"] = {"launches": got["flash_fwd"], "calls": calls,
                    "per_engine_call": per_engine_call,
                    "prefill_alone": prefill_launches["flash_fwd"],
                    "per_decode_step": ((per_engine_call - prefill_launches["flash_fwd"])
                                        / (st[-1]["steps"] - 1)),
                    "prefill_ms": [s["prefill_s"] * 1e3 for s in st],
                    "decode_tps": [s["decode_tokens"] / s["decode_s"] for s in st]}

    # (c) drops in the served prefill, by layer; the kernel route against
    # the plain one; one layer in bf16 against fp32
    pad_rows = ~batch[1].bool().reshape(-1)
    drops = moe_drops(torch, recorder.calls, pad_rows)
    if len(drops) != MOE_LAYERS or any(d["n"] != b * p for d in drops):
        fail(f"the served prefill made {len(drops)} MoE calls, not one per layer at N = {b * p}")
    log(f"moe drops [{card}] served prefill (N = {b * p} rows, {int(pad_rows.sum())} of them "
        f"left pads; C = {drops[0]['cap']}): tokens with a dropped choice per layer "
        f"{[d['tokens'] for d in drops]}, of them pads {[d['pad_tokens'] for d in drops]}; "
        f"(token, expert) pairs dropped {sum(d['pairs'] for d in drops)} of "
        f"{MOE_LAYERS * b * p * dec.num_experts_per_tok}")
    out["drops_prefill"] = drops
    out["slots"] = moe_slots_check(torch, card, recorder.calls, dec.num_experts, pad_rows,
                                   recorder.inputs[0][1])
    one = [torch.as_tensor(a, device="cuda")
           for a in prepare_batch(processor, cfg, items[:1])]
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"),
        decoder=dataclasses.replace(dec, attention_impl="xla"))
    reset_counts()
    k_logits = server.engine.prefill(model, *one, MOE_NEW)[0]
    k_launches = counts()["flash_fwd"]
    p_logits = GenerationEngine(plain_cfg, -1).prefill(model, *one, MOE_NEW)[0]
    cos = float(F.cosine_similarity(k_logits, p_logits, dim=-1).min())
    log(f"moe [{card}] kernel vs plain route, one request's last-column prefill logits: "
        f"cosine {cos:.6f} (>= {MOE_ROUTE_COS}), max abs diff "
        f"{float((k_logits - p_logits).abs().max()):.4g} (|logit| max "
        f"{float(p_logits.abs().max()):.3g}), same argmax "
        f"{bool((k_logits.argmax(-1) == p_logits.argmax(-1)).all())}; {k_launches} flash_fwd")
    if cos < MOE_ROUTE_COS or k_launches != per_call or not bool(torch.isfinite(k_logits).all()):
        fail(f"kernel and plain routes disagree on the MoE model (cosine {cos:.4f}, "
             f"{k_launches} launches)")
    moe0, x0, _, _ = recorder.inputs[0]
    out["layer"] = moe_layer_check(torch, card, moe0, x0, cfg)
    del recorder, x0
    torch.cuda.empty_cache()

    # (d) grouped decode: 2 prompts x G = 4, greedy, twice
    engine = GenerationEngine(cfg, eos_token_id=-1)
    two = [torch.as_tensor(a, device="cuda") for a in prepare_batch(processor, cfg, items[:2])]
    reset_counts()
    g1, _ = engine.generate(model, *two, greedy=True, max_new_tokens=MOE_GROUP_NEW, group_size=4)
    g_launches = counts()["flash_fwd"]
    gst = dict(engine.last_stats)
    g2, _ = engine.generate(model, *two, greedy=True, max_new_tokens=MOE_GROUP_NEW, group_size=4)
    same_in_group = all((g1[4 * i: 4 * i + 4] == g1[4 * i]).all() for i in range(2))
    log(f"moe grouped [{card}]: 2 prompts x G=4, {MOE_GROUP_NEW} greedy tokens: completions of "
        f"a prompt equal {same_in_group}, two runs equal {bool((g1 == g2).all())}; "
        f"{g_launches} flash_fwd; prefill {gst['prefill_s'] * 1e3:.1f} ms, decode "
        f"{gst['decode_tokens'] / gst['decode_s']:.1f} tokens/s")
    if not same_in_group or not (g1 == g2).all() or g_launches != per_call:
        fail("the grouped MoE decode's completions differ within a group or between runs")
    out["grouped"] = {"tps": gst["decode_tokens"] / gst["decode_s"]}

    # (e) continuous: the serving bench (`bench_serve.drive`) at 16 slots, 32 requests;
    # each decode window's MoE calls (k steps x 48 layers at its cb rows)
    # marked by wrapping the batcher's window
    from bioreason_tpu_torch.generate import continuous as C
    args = bench_serve.parse_args(["--capacity", "16", "--requests", "32", "--max_new",
                                   str(MOE_BENCH_NEW), "--probe"])
    recorder, marks = MoeRecorder(), []
    real_multi = C.ContinuousBatcher._multi_step

    def multi_step(self, st, k, w, cb, *a, **kw):
        start = len(recorder.calls)
        toks = real_multi(self, st, k, w, cb, *a, **kw)
        marks.append((cb, recorder.calls[start:]))
        return toks
    C.ContinuousBatcher._multi_step = multi_step
    reset_counts()
    try:
        res = bench_serve.drive(model, cfg, args)
    finally:
        recorder.close()
        C.ContinuousBatcher._multi_step = real_multi
    got = counts()
    per_window = [(cb, sum(d["tokens"] for d in moe_drops(torch, calls_)))
                  for cb, calls_ in marks]
    log(f"moe continuous [{card}]: {res['value']:.1f} decoded tokens/s ({res['decoded_tokens']} "
        f"tokens, {res['requests']} requests over {res['capacity']} slots in "
        f"{res['seconds']:.2f} s; admit {res['admit_s']:.2f} s); {res['windows']} windows, "
        f"mean occupancy {res['mean_occupancy']:.3f}; pools {res['pool_gib']:.3f} GiB; "
        f"{res['prefill_calls']} prefill calls, {res['flash_fwd_per_prefill']:g} flash_fwd "
        f"each; rows with a dropped choice per decode window (cb rows: rows dropped, summed "
        f"over its steps and 48 layers) {per_window}; launches with the warmup {got}")
    if got != {k: (per_call * (res["prefill_calls"] + 1) if k == "flash_fwd" else 0)
               for k in got}:
        fail(f"the MoE bench launched {got}: expected {per_call} flash_fwd per prefill chunk "
             f"(and its warmup's one) and nothing else")
    out["continuous"] = {**res, "launches": got["flash_fwd"], "drops_per_window": per_window}
    del recorder
    torch.cuda.empty_cache()

    # (g) the profile of one prefill and one decode step, with the expert
    # products' bound (bf16 storage) from the kept pairs and the experts
    # picked in that prefill and step
    recorder = MoeRecorder()
    try:
        with torch.inference_mode():
            _, cache, cmask = engine.prefill(model, *batch, 2)
            cmask[:, p] = 1
            decoder_forward(model.decoder, dec, input_ids=torch.zeros((b, 1), dtype=torch.int64,
                                                                      device="cuda"),
                            attention_mask=torch.ones((b, 1), dtype=torch.int32,
                                                      device="cuda"),
                            positions=batch[1].sum(-1)[:, None], cache=cache, cache_index=p,
                            cache_mask=cmask)
        torch.cuda.synchronize()
    finally:
        recorder.close()
    del cache
    kept = {}
    for what, calls_ in (("prefill", recorder.calls[:MOE_LAYERS]),
                         ("decode", recorder.calls[MOE_LAYERS:])):
        kept[what] = ([int(c["keep"].sum()) for c in calls_],
                      [int(torch.unique(c["idx"][c["keep"]]).numel()) for c in calls_])
    out["profile_bf16"] = moe_profile(torch, card, model, cfg, batch, "bf16")
    out["bound"] = {"prefill": moe_expert_bound(cfg, b * p, kept["prefill"], "prefill"),
                    "decode": moe_expert_bound(cfg, b, kept["decode"], "decode step")}

    # (f) int8: the bf16 teacher-forced logits first, then the storage
    # quantized in place (both copies at once would need 86 GiB)
    ids_bf, _ = engine.generate(model, *batch, greedy=True, max_new_tokens=MOE_INT8_NEW)
    streams = torch.as_tensor(ids_bf, device="cuda")
    lg_bf = teacher_forced(torch, engine, model, batch, streams)
    kept_banks = {li: {name: getattr(model.decoder.layers[li].mlp.experts, name).weight.clone()
                       for name in ("gate", "up", "down")} for li in MOE_BANK_LAYERS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serving_storage(model, int8=True)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    resident8 = storage_bytes(model)
    lg8 = teacher_forced(torch, engine, model, batch, streams)
    cos = F.cosine_similarity(lg8, lg_bf, dim=-1)
    top = float((lg8.argmax(-1) == lg_bf.argmax(-1)).float().mean())
    steps = moe_bank_steps(torch, model, kept_banks)
    faults = {}
    for name, fault in MOE_BANK_FAULTS.items():
        with moe_bank_scale_fault(torch, model, fault):
            c = F.cosine_similarity(teacher_forced(torch, engine, model, batch, streams), lg_bf,
                                    dim=-1)
            faults[name] = {"cos_min": float(c.min()), "cos_median": float(c.median()),
                            "bank_steps": moe_bank_steps(torch, model, kept_banks)}
    del kept_banks
    reset_counts()
    ids8, _ = engine.generate(model, *batch, greedy=True, max_new_tokens=MOE_INT8_NEW)
    got8 = counts()
    st8 = dict(engine.last_stats)
    log(f"moe int8 [{card}]: quantized in place in {t_q:.2f} s (banks [E, 1, out] scales, "
        f"the router too); resident {resident8 / 2**30:.2f} GiB ({resident8 / resident:.3f} of "
        f"bf16's {resident / 2**30:.2f}); teacher-forced logits against bf16: cosine min "
        f"{float(cos.min()):.6f}, median {float(cos.median()):.6f} over {cos.numel()} (row, "
        f"step) pairs (>= {MOE_INT8_COS_FLOOR}); argmax agreement {top:.3f}; layers "
        f"{list(MOE_BANK_LAYERS)}' banks against their bf16: largest error {steps:.6f} steps "
        f"(<= {MOE_BANK_STEPS}); planted faults of the banks' scales: "
        + "; ".join(f"{k}: cosine min {v['cos_min']:.6f}, median {v['cos_median']:.6f}, "
                    f"largest bank error {v['bank_steps']:.3f} steps (must be over "
                    f"{MOE_BANK_STEPS})" for k, v in faults.items())
        + f"; one engine call "
        f"of {MOE_INT8_NEW} tokens: prefill {st8['prefill_s'] * 1e3:.1f} ms, decode "
        f"{st8['decode_tokens'] / st8['decode_s']:.1f} tokens/s; launches {got8}")
    if (float(cos.min()) < MOE_INT8_COS_FLOOR or not bool(torch.isfinite(lg8).all())
            or got8["flash_fwd"] != per_call or not 0.45 < resident8 / resident < 0.55):
        fail(f"moe int8: cosine {float(cos.min()):.6f}, launches {got8}, resident share "
             f"{resident8 / resident:.3f}")
    if steps > MOE_BANK_STEPS:
        fail(f"the int8 banks are {steps:.6f} quantization steps off their bf16, over "
             f"{MOE_BANK_STEPS}")
    missed = [k for k, v in faults.items() if v["bank_steps"] <= MOE_BANK_STEPS]
    if missed:
        fail(f"the bound of {MOE_BANK_STEPS} steps misses the planted faults {missed}")
    if all(v["cos_min"] >= MOE_INT8_COS_FLOOR for v in faults.values()):
        fail(f"no planted fault of the int8 banks reads under the floor {MOE_INT8_COS_FLOOR}")
    out["int8"] = {"gib": resident8 / 2**30, "cos_min": float(cos.min()),
                   "cos_median": float(cos.median()), "argmax_agree": top,
                   "bank_steps": steps, "faults": faults,
                   "decode_tps": st8["decode_tokens"] / st8["decode_s"],
                   "prefill_ms": st8["prefill_s"] * 1e3}
    del lg8, lg_bf
    out["profile_int8"] = moe_profile(torch, card, model, cfg, batch, "int8")

    # (h) flash_fwd at the MoE prefill's shape: 32 q heads over 4 KV heads,
    # the served left pads, a cache of P + 64
    del model, server, engine
    gc.collect()
    torch.cuda.empty_cache()
    cmask = F.pad(batch[1].to(torch.int32), (0, MOE_NEW))
    rows = [kernel_case(torch, f"moe_prefill_P{p}", b, p, p + MOE_NEW, 32, 4, 128, True, 0,
                        cmask, 171)]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe: phase done in {out['seconds']:.1f} s (budget {MOE_BUDGET_S:g})")
    if out["seconds"] > MOE_BUDGET_S:
        fail(f"the moe phase took {out['seconds']:.1f} s, over {MOE_BUDGET_S:g}")
    return out, rows


# -- phase 18 ----------------------------------------------------------------

# the device of phases 18-19 ("cpu" only to rehearse them at tiny widths)
DEV = "cuda"
MOE_TRAIN_BUDGET_S = 240.0
MOE_SFT_STEPS = 3
MOE_GRPO_STEPS = 1                     # cut from 2 for the script's time
MOE_GRPO_NEW = 32                      # half bench_grpo.py's 64, for the script's time
MOE_SFT_LR = 1e-3                      # no warm-up: the loss must fall in 3 steps
# (c) the kernel route against the plain route, one step's loss and trainable
# gradients: the routes round apart (bf16 P against fp32), and a token whose
# router sits on a near-tie can take another expert in some layer, so the
# bound is looser than the dense decoder's cosine of 0.99 (phase 6)
MOE_ROUTE_LOSS_RTOL, MOE_ROUTE_GRAD_COS = 1e-2, 0.98
# (e) the first QLoRA step's loss against (b)'s first: both start from the same
# adapters (B = 0) and projection, so they differ by int8's rounding alone
MOE_QLORA_LOSS_RTOL = 1e-2
MOE_TWIN_LAYERS = 2                    # (e)'s twin: Qwen3-30B-A3B width, cut in depth


def adapted_linears(torch, model):
    from bioreason_tpu_torch.models.layers import has_adapter
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear) and has_adapter(m)]


def banks(model):
    from bioreason_tpu_torch.models.layers import ExpertBank
    return [m for m in model.modules() if isinstance(m, ExpertBank)]


def moe_sft_steps(torch, card, label, trainer, batch, steps, per_step):
    """`steps` SFTTrainer steps on one repeated batch (the main path: counts
    from 0 just before, read just after); the forward's and the recompute's
    routing recorded in the first. Returns the numbers."""
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = MoeRecorder()
    metrics, step_s = [], []
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if i == 0:
                rec.close()
    finally:
        rec.close()
    got = all_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in metrics]
    b = batch["input_ids"].shape[0]
    ms = 1e3 * sum(step_s[1:]) / max(1, steps - 1)
    log(f"moe_train {label} [{card}]: {steps} SFT steps at B={b} T="
        f"{batch['input_ids'].shape[1]} + DNA {list(batch['dna_input_ids'].shape)}, remat "
        f"{trainer.fusion_cfg.decoder.remat}: step s {[round(x, 3) for x in step_s]}, {ms:.1f} ms "
        f"a step after the first ({b * 1e3 / ms:.3f} examples/s), peak {peak:.2f} GiB; losses "
        f"{[round(x, 6) for x in losses]}; launches {got}")
    want = {k: steps * per_step.get(k, 0) for k in got}
    if got != want:
        fail(f"moe_train {label}: launched {got} in {steps} steps, reckoned {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"moe_train {label}: the loss is not finite or does not fall: {losses}")
    # the recompute routes as the forward did: two calls a layer, equal
    by_mod = {}
    for call in rec.calls:
        by_mod.setdefault(call["module"], []).append(call)
    layers = trainer.model.decoder.layers
    alike = sum(len(c) == 2 and all(torch.equal(c[0][k], c[1][k]) for k in ("idx", "keep"))
                for c in by_mod.values())
    dropped = [float((~c[0]["keep"]).float().mean()) for c in by_mod.values()]
    log(f"moe_train {label}: forward and recompute routed alike (experts and keep flags) in "
        f"{alike} of {len(layers)} layers ({len(rec.calls)} MoE calls in the step); the "
        f"(token, choice) pairs dropped per layer {min(dropped):.3f}-{max(dropped):.3f}")
    if len(by_mod) != len(layers) or alike != len(layers):
        fail(f"moe_train {label}: the recompute routed otherwise than the forward "
             f"({alike} of {len(layers)} layers alike, {len(by_mod)} modules seen)")
    return {"losses": losses, "step_s": step_s, "ms": ms, "examples_per_s": b * 1e3 / ms,
            "peak_gib": peak, "launches": got, "layers_alike": alike,
            "dropped_share": [min(dropped), max(dropped)]}


def moe_grpo_steps(torch, card, label, trainer, items, steps, per_step):
    """`steps` GRPOTrainer steps (the main path, counts from 0), with the
    trainer's phase timers; the reference policy and the rollout policy
    hold the training model's expert banks themselves."""
    bank_ptrs = {b.weight.data_ptr() for b in banks(trainer.model)}
    for what, m in (("reference", trainer.ref_model), ("rollout", trainer.rollout_model())):
        ptrs = {b.weight.data_ptr() for b in banks(m)}
        if ptrs != bank_ptrs:
            fail(f"moe_train {label}: the {what} policy does not share the expert banks' "
                 f"storage ({len(ptrs - bank_ptrs)} of {len(ptrs)} banks its own)")
    log(f"moe_train {label}: the reference and the rollout policy hold the model's "
        f"{len(bank_ptrs)} expert banks themselves (data_ptr)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.timers = {}
    reset_counts()
    t0 = time.perf_counter()
    hist = [trainer.step(items) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = all_counts()
    tm, trainer.timers = trainer.timers, None
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"moe_train {label} [{card}]: {steps} GRPO steps of {len(items)} completions "
        f"({trainer.cfg.num_generations} a prompt, {trainer.cfg.max_completion_length} new "
        f"tokens, P={trainer.engine.last_stats['prompt_len']}) in {dt:.1f} s: "
        f"{len(items) * steps / dt:.3f} completions/s; seconds by phase "
        f"{ {k: round(v, 3) for k, v in tm.items()} }; peak {peak:.2f} GiB; per step "
        + "; ".join(f"loss {m['loss']:.5g} kl {m['kl']:.4g} reward {m['reward']:.3g}"
                    for m in hist) + f"; launches {got}")
    want = {k: steps * per_step.get(k, 0) for k in got}
    if got != want:
        fail(f"moe_train {label}: launched {got} in {steps} GRPO steps, reckoned {want}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["kl"]) for m in hist):
        fail(f"moe_train {label}: a non-finite GRPO loss or kl: {hist}")
    return {"completions_per_s": len(items) * steps / dt, "s_per_step": dt / steps,
            "timers": tm, "peak_gib": peak, "launches": got,
            "loss": [m["loss"] for m in hist], "kl": [m["kl"] for m in hist]}


def moe_twin_and_saved_banks(torch, card, cfg, batch):
    """(e), at Qwen3-30B-A3B width cut to MOE_TWIN_LAYERS layers: one QLoRA
    step's loss and gradients against a bf16 twin holding the dequantized
    weights and banks (`qlora_twin_check`), then, with remat off, what one
    step's autograd saves of the banks and its peak memory, the int8 bank
    product (`layers.bank_product`) against `torch.bmm` on the dequantized
    bank (a planted plain path), beside the reckoned bytes of a saved bf16
    copy of every bank."""
    import gc

    from bioreason_tpu_torch.config import LoRAConfig, OptimConfig, SFTConfig
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.sft import SFTTrainer
    cut = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               num_layers=MOE_TWIN_LAYERS))
    model = init_fusion(cut, seed=0, device=DEV)
    # no LoRA dropout: each loss of the check must see the same function
    sft = SFTConfig(batch_size=4, frozen_dtype="int8", lora=LoRAConfig(dropout=0.0),
                    optim=OptimConfig(learning_rate=MOE_SFT_LR, warmup_ratio=0.0,
                                      total_steps=100), seed=0)
    trainer = SFTTrainer(cut, sft, model=model, device=DEV)
    twin = qlora_twin_check(torch, trainer, batch)
    e, h, inter = cut.decoder.num_experts, cut.decoder.hidden_size, \
        cut.decoder.moe_intermediate_size
    bank_bytes = 3 * e * h * inter * 2                     # a layer's banks in bf16
    reckoned = MOE_TWIN_LAYERS * bank_bytes
    n = batch["input_ids"].shape[0] * batch["input_ids"].shape[1]
    cap = L.moe_capacity(n, e, cut.decoder.num_experts_per_tok, cut.decoder.moe_capacity_factor)
    if cap in (h, inter):
        fail(f"moe_train (e): a capacity of {cap} gives activations a bank's shape")
    off = dataclasses.replace(cut, decoder=dataclasses.replace(cut.decoder, remat=False))
    trainer.fusion_cfg = off
    db = trainer._device_batch(batch)

    def step():
        """One loss and its trainable gradients; the bytes of float [E, in,
        out] tensors autograd saved; the peak above the resident."""
        saved = []

        def pack(x):
            if tuple(x.shape) in ((e, h, inter), (e, inter, h)) and x.dtype.is_floating_point:
                saved.append(x.numel() * x.element_size())
            return x
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss = trainer._loss(db, train=True)
        torch.autograd.grad(loss, trainer.params, allow_unused=True)
        torch.cuda.synchronize()
        return sum(saved), (torch.cuda.max_memory_allocated() - base) / 2**30
    int8_saved, int8_peak = step()
    real = L.bank_product
    L.bank_product = lambda x, bank, dtype, ep=None: torch.bmm(x, L.expert_bank(bank, dtype))
    try:
        plain_saved, plain_peak = step()
    finally:
        L.bank_product = real
    log(f"moe_train (e) [{card}]: {MOE_TWIN_LAYERS}-layer Qwen3-30B-A3B, remat off: the int8 "
        f"bank product saved {int8_saved / 2**30:.3f} GiB of float banks, peak "
        f"{int8_peak:.3f} GiB above the resident; torch.bmm on the dequantized banks saved "
        f"{plain_saved / 2**30:.3f} GiB, peak {plain_peak:.3f} GiB; reckoned: a bf16 copy of "
        f"every bank {reckoned / 2**30:.3f} GiB ({bank_bytes / 2**30:.3f} a layer, "
        f"{bank_bytes * cfg.decoder.num_layers / 2**30:.1f} GiB over {cfg.decoder.num_layers})")
    if int8_saved or plain_saved < reckoned or plain_peak - int8_peak < 0.75 * reckoned / 2**30:
        fail(f"moe_train (e): the int8 bank product saved {int8_saved} bytes of float banks "
             f"(reckoned 0) and peaked {int8_peak:.3f} GiB against the plain path's "
             f"{plain_peak:.3f} GiB ({plain_saved} bytes saved, reckoned {reckoned})")
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"twin": twin, "saved_float_bank_bytes": int8_saved, "peak_gib": int8_peak,
            "plain_saved_bytes": plain_saved, "plain_peak_gib": plain_peak,
            "reckoned_bytes": reckoned}


def phase_moe_train(torch, card):
    """MoE training at Qwen3-30B-A3B + NT-v2-500M, full width and depth
    (module docstring, phase 18)."""
    import gc

    import torch.nn.functional as F
    from bioreason_tpu_torch.config import (GRPOConfig, LoRAConfig, OptimConfig,
                                            SamplingConfig, SFTConfig)
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.models.fusion import fusion_forward, init_fusion
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.lora import strip_lora
    from bioreason_tpu_torch.train.quant import storage_bytes
    from bioreason_tpu_torch.train.sft import SFTTrainer
    t_phase = time.perf_counter()
    out = {}

    # (a) build: nothing of the earlier phases left, the model in bf16 on
    # the card, LoRA r32/a64 on q, k, v, o and the router of every layer
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"moe_train: {left / 2**30:.3f} GiB allocated before the build")
    if left > 2 * 2**30:
        fail(f"{left / 2**30:.2f} GiB of earlier phases is still allocated")
    cfg, processor = moe_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, remat=True,
                                                               remat_policy="full"),
                              encoder=dataclasses.replace(cfg.encoder, remat=False))
    dec = cfg.decoder
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_fusion(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    dtypes0 = {n: p.dtype for n, p in model.named_parameters()}
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(),
                    optim=OptimConfig(learning_rate=MOE_SFT_LR, warmup_ratio=0.0,
                                      total_steps=100), seed=0)
    trainer = SFTTrainer(cfg, sft, model=model, device=DEV)
    adapted = adapted_linears(torch, model)
    per_layer = {n.split(".")[-1] for n in adapted}
    upcast = [n for n, p in model.named_parameters()
              if not p.requires_grad and p.dtype.itemsize > dtypes0[n].itemsize]
    n_train = sum(p.numel() for p in trainer.params)
    resident = storage_bytes(model) / 2**30
    log(f"moe_train (a) [{card}]: Qwen3-30B-A3B + NT-v2-500M in {dec.dtype} on the card in "
        f"{t_build:.2f} s, {resident:.2f} GiB resident with the adapters; LoRA r"
        f"{sft.lora.r}/a{sft.lora.alpha} on {len(adapted)} linears ({sorted(per_layer)} of "
        f"each layer), {n_train / 1e6:.3f} M trainable parameters in {len(trainer.params)} "
        f"tensors; frozen leaves up-cast: {len(upcast)}")
    if (len(adapted) != 5 * dec.num_layers or per_layer != {"q", "k", "v", "o", "router"}
            or not all(n.startswith("decoder.layers.") for n in adapted)):
        fail(f"moe_train (a): expected 5 adapted linears in each of {dec.num_layers} layers, "
             f"the routers among them; got {len(adapted)} ({sorted(per_layer)})")
    if upcast or any(b.weight.requires_grad or b.weight.dtype != torch.bfloat16
                     for b in banks(model)):
        fail(f"moe_train (a): frozen leaves up-cast or banks not frozen bf16: {upcast[:6]}")
    out["build"] = {"s": t_build, "resident_gib": resident, "adapted": len(adapted),
                    "trainable_params": n_train}
    proj0 = {n: p.detach().clone() for n, p in model.dna_projection.named_parameters()}

    # (b) SFT at bench.py's shape, remat on: the encoder's 29 flash_fwd, the
    # decoder's 48 and their 48 recomputed ones, 48 flash_bwd a step
    batch = bench_batch(cfg)
    per_step = {"flash_fwd": ENCODER_LAYERS + 2 * dec.num_layers, "flash_bwd": dec.num_layers}
    out["sft"] = moe_sft_steps(torch, card, "(b) bf16 LoRA", trainer, batch, MOE_SFT_STEPS,
                               per_step)
    # where a step's device time goes, and how much of the step it is busy
    out["sft"]["profile"] = profile_step(torch, card, "moe_train (b) one bf16 SFT step",
                                         lambda: trainer.train_step(batch),
                                         ("flash_fwd", "flash_bwd", "nvjet", "gemm"))[:2]

    # (c) one step's loss and trainable gradients, kernel route against plain
    db = trainer._device_batch(batch)

    def loss_and_grad(c):
        _, loss = fusion_forward(trainer.model, c, db["input_ids"], db["attention_mask"],
                                 db["dna_input_ids"], db["dna_attention_mask"],
                                 label_positions=db["label_positions"],
                                 label_targets=db["label_targets"],
                                 label_valid=db["label_valid"])
        grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        return float(loss.detach()), torch.cat([
            (torch.zeros_like(p) if g is None else g).float().flatten()
            for p, g in zip(trainer.params, grads)])
    # where a step's time goes, on the host's clock: the forward alone, then
    # the forward with the recompute and the backward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        fusion_forward(trainer.model, cfg, db["input_ids"], db["attention_mask"],
                       db["dna_input_ids"], db["dna_attention_mask"],
                       label_positions=db["label_positions"], label_targets=db["label_targets"],
                       label_valid=db["label_valid"])
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    lk, gk = loss_and_grad(cfg)
    torch.cuda.synchronize()
    t_lg = time.perf_counter() - t0 - t_fwd
    log(f"moe_train (b) a step's parts, each timed alone (host clock): the forward "
        f"{t_fwd * 1e3:.1f} ms, the forward with the recompute and the backward "
        f"{t_lg * 1e3:.1f} ms, the whole step {out['sft']['ms']:.1f} ms")
    out["sft"]["split_ms"] = {"forward": t_fwd * 1e3, "forward_backward": t_lg * 1e3}
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(dec, attention_impl="xla"),
                                encoder=dataclasses.replace(cfg.encoder, attention_impl="xla"))
    lp, gp = loss_and_grad(plain)
    cos = float(F.cosine_similarity(gk, gp, dim=0))
    rel = abs(lk - lp) / abs(lp)
    log(f"moe_train (c): kernel vs plain route, one loss + gradient: loss {lk:.6f} vs {lp:.6f} "
        f"(relative {rel:.3g}, held to {MOE_ROUTE_LOSS_RTOL}), cosine of the {gk.numel()} "
        f"trainable gradients {cos:.6f} (held to {MOE_ROUTE_GRAD_COS})")
    if not (math.isfinite(lk) and rel <= MOE_ROUTE_LOSS_RTOL and cos >= MOE_ROUTE_GRAD_COS):
        fail(f"moe_train (c): the kernel and plain routes disagree (loss rel {rel:.3g}, "
             f"cosine {cos:.4f})")
    out["route"] = {"loss": lk, "plain_loss": lp, "loss_rel": rel, "grad_cos": cos}
    del gk, gp, db
    ones = torch.ones((4, 768), dtype=torch.int32, device=DEV)
    out["fwd_row"] = kernel_case(torch, "moe_sft_T768", 4, 768, 768, dec.num_heads,
                                 dec.num_kv_heads, dec.head_dim, True, 0, ones, 51)
    out["bwd_row"] = bwd_case(torch, "moe_sft_T768_bwd", 4, 768, 768, dec.num_heads,
                              dec.num_kv_heads, dec.head_dim, True, 0, ones, 51)
    del trainer
    gc.collect()

    # (d) GRPO at bench_grpo.py's shape: beta > 0, float rollouts, no sync
    gcfg = dataclasses.replace(cfg, max_length_text=512, max_length_dna=128)
    grpo = GRPOConfig(num_generations=GRPO_G, batch_size=GRPO_PROMPTS * GRPO_G, beta=0.04,
                      max_completion_length=MOE_GRPO_NEW,
                      sampling=SamplingConfig(max_new_tokens=MOE_GRPO_NEW),
                      optim=OptimConfig(learning_rate=5e-6, total_steps=100),
                      lora=LoRAConfig(), seed=0)
    items = [format_kegg_prompt_only(it)
             for it in synthetic_kegg_items(GRPO_PROMPTS, seq_len=600, seed=0)]
    items = [x for x in items for _ in range(GRPO_G)]
    g_per_step = {"flash_fwd": dec.num_layers + 3 * ENCODER_LAYERS + 3 * dec.num_layers,
                  "flash_bwd": dec.num_layers}
    gt = GRPOTrainer(gcfg, grpo, processor, [acgt_share_reward], model=model, device=DEV)
    out["grpo"] = moe_grpo_steps(torch, card, "(d) bf16 GRPO", gt, items, MOE_GRPO_STEPS,
                                 g_per_step)
    del gt
    gc.collect()
    torch.cuda.empty_cache()

    # (e) QLoRA: fresh adapters from (b)'s seed, the projection as (b) began,
    # the frozen towers int8 in place
    strip_lora(model)
    with torch.no_grad():
        for n, p in model.dna_projection.named_parameters():
            p.copy_(proj0[n])
    # quantizing in place frees each bf16 bank as its int8 one is stored:
    # nothing else may hold them (both copies would need 86.8 GiB)
    log(f"moe_train (e): {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
        f"quantizing ({storage_bytes(model) / 2**30:.2f} GiB the model's)")
    qtrainer = SFTTrainer(cfg, dataclasses.replace(sft, frozen_dtype="int8"), model=model,
                           device=DEV)
    gc.collect()
    torch.cuda.empty_cache()
    resident_q = storage_bytes(model) / 2**30
    log(f"moe_train (e) [{card}]: QLoRA in place: {resident_q:.2f} GiB resident (bf16 "
        f"{resident:.2f}), every bank int8: "
        f"{all(b.weight.dtype == torch.int8 for b in banks(model))}")
    out["qlora_sft"] = moe_sft_steps(torch, card, "(e) QLoRA", qtrainer, batch, MOE_SFT_STEPS,
                                     per_step)
    l_b, l_e = out["sft"]["losses"][0], out["qlora_sft"]["losses"][0]
    q_rel = abs(l_e - l_b) / abs(l_b)
    log(f"moe_train (e): first loss QLoRA {l_e:.6f} vs bf16 {l_b:.6f} (relative {q_rel:.3g}, "
        f"held to {MOE_QLORA_LOSS_RTOL}); peak {out['qlora_sft']['peak_gib']:.2f} GiB vs "
        f"{out['sft']['peak_gib']:.2f} GiB")
    if q_rel > MOE_QLORA_LOSS_RTOL or not all(b.weight.dtype == torch.int8 for b in banks(model)):
        fail(f"moe_train (e): QLoRA's first loss {l_e} against bf16's {l_b}")
    out["qlora_sft"]["resident_gib"] = resident_q
    del qtrainer
    gc.collect()
    gq = GRPOTrainer(gcfg, dataclasses.replace(grpo, frozen_dtype="int8", rollout_int8=True),
                     processor, [acgt_share_reward], model=model, device=DEV)
    out["qlora_grpo"] = moe_grpo_steps(torch, card, "(e) QLoRA GRPO, int8 rollouts", gq, items,
                                       1, g_per_step)
    del gq, model
    gc.collect()
    torch.cuda.empty_cache()
    out["twin"] = moe_twin_and_saved_banks(torch, card, cfg, batch)
    secs = time.perf_counter() - t_phase
    log(f"moe_train: {secs:.1f} s of the script's clock (budget {MOE_TRAIN_BUDGET_S:.0f} s)")
    out["s"] = secs
    return out


# -- phase 19 ----------------------------------------------------------------

FP32_API_BUDGET_S = 90.0
FP32_STEPS = 3
# the fp32 kernels against the plain route over three steps: the same fp32
# products summed in another order, then three Adam updates
FP32_LOSS_RTOL = 1e-4
FP32_API_PROMPTS, FP32_TRACE_ITEMS = 8, 4


def phase_fp32_api(torch, card):
    """The fp32 route and the user API at Qwen3-0.6B + NT-v2-50M (module
    docstring, phase 19)."""
    from bioreason_tpu_torch.cli import make_traces, train_sft
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.data import ByteTextTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    from bioreason_tpu_torch.models.api import DnaLLM
    from bioreason_tpu_torch.models.fusion import init_fusion
    from bioreason_tpu_torch.train.sft import SFTTrainer
    t_phase = time.perf_counter()
    out = {}
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_fp32_", dir=build_dir)
    try:
        # (a) train_sft --dtype float32: the route that raised before the
        # fp32 kernels; the decoder's 28 layers twice (remat) and 28
        # backward a step, none from NT-v2-50M's 32-wide heads
        reset_counts()
        t0 = time.perf_counter()
        tr = train_sft.main(["--dtype", "float32", "--decoder", "qwen3-0.6b", "--encoder",
                             "nt-50m", "--max_steps", "2", "--seed", "0", "--checkpoint_dir",
                             tmp, "--device", DEV])
        secs = time.perf_counter() - t0
        got = all_counts()
        losses = [m["loss"] for m in tr.history]
        want = {k: 0 for k in got}
        want.update(flash_f32_fwd=2 * 2 * DECODER_LAYERS, flash_f32_bwd=2 * DECODER_LAYERS)
        log(f"fp32 (a) train_sft --dtype float32 --decoder qwen3-0.6b --encoder nt-50m "
            f"[{card}]: 2 steps in {secs:.1f} s (build and data included), losses "
            f"{[round(x, 5) for x in losses]}; launches {got}")
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses) or got != want:
            fail(f"fp32 (a): train_sft --dtype float32 ran {losses}, launched {got}, "
                 f"reckoned {want}")
        out["cli"] = {"losses": losses, "launches": got, "s": secs}
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) 3 SFTTrainer steps on the fp32 model through the kernels and again
    # on the plain route, from the same weights, at bench.py's batch cut to
    # 512 text tokens (its placeholder id past the random text ids)
    cfg = FusionConfig(decoder=dataclasses.replace(DecoderConfig.qwen3_0_6b(), dtype="float32"),
                       encoder=dataclasses.replace(EncoderConfig.nt_v2_50m(), dtype="float32"),
                       dna_pad_token_id=151938)
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(dropout=0.0),
                    optim=OptimConfig(learning_rate=1e-4, warmup_ratio=0.0, total_steps=100),
                    seed=0)
    batch = bench_batch(cfg, t_text=512)
    runs = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                 attention_impl=impl))
        trainer = SFTTrainer(c, sft, model=init_fusion(c, seed=0, device=DEV), device=DEV)
        reset_counts()
        t0 = time.perf_counter()
        losses, step_ms = [], []
        for _ in range(FP32_STEPS):
            t1 = time.perf_counter()
            losses.append(trainer.train_step(batch)["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        runs[impl] = {"losses": losses, "s": time.perf_counter() - t0, "step_ms": step_ms,
                      "launches": all_counts()}
        if impl == "auto":
            model = trainer.model
        del trainer
    k, x = runs["auto"], runs["xla"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], x["losses"]))
    per = (2 if cfg.decoder.remat else 1) * DECODER_LAYERS
    want = {kk: 0 for kk in k["launches"]}
    want.update(flash_f32_fwd=FP32_STEPS * per, flash_f32_bwd=FP32_STEPS * DECODER_LAYERS)
    log(f"fp32 (b) SFTTrainer [{card}]: {FP32_STEPS} steps at B=4 T=512 in fp32: kernels "
        f"{[round(v, 7) for v in k['losses']]} in {k['s']:.2f} s (ms a step "
        f"{[round(v, 1) for v in k['step_ms']]}; launches {k['launches']}), plain "
        f"{[round(v, 7) for v in x['losses']]} in {x['s']:.2f} s (ms a step "
        f"{[round(v, 1) for v in x['step_ms']]}); largest relative difference {rel:.3g} "
        f"(held to {FP32_LOSS_RTOL})")
    if (rel > FP32_LOSS_RTOL or k["launches"] != want or any(x["launches"].values())
            or not all(math.isfinite(v) for v in k["losses"])):
        fail(f"fp32 (b): the kernel route's losses {k['losses']} against the plain route's "
             f"{x['losses']}, launches {k['launches']} (reckoned {want}) and {x['launches']}")
    out["trainer"] = {"kernels": k, "plain": x, "loss_rel": rel}

    # (c) the user API: DnaLLM over that fp32 model, greedy text for 8 KEGG
    # prompts (one engine call: the prefill's 28 flash_f32_fwd)
    items = [format_kegg_prompt_only(it)
             for it in synthetic_kegg_items(FP32_API_PROMPTS, seq_len=600, seed=0)]
    texts = [apply_chat_template(ex)["prompt"] for ex in items]
    dna = [ex["dna_sequences"] for ex in items]
    tok = ByteTextTokenizer()
    api = DnaLLM(dataclasses.replace(cfg, dna_pad_token_id=tok.dna_pad_id), text_tokenizer=tok,
                 model=model.requires_grad_(False), device=DEV)
    reset_counts()
    t0 = time.perf_counter()
    answers = api.generate_text(texts, dna, greedy=True, max_new_tokens=32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = all_counts()
    log(f"fp32 (c) DnaLLM.generate_text [{card}]: {len(answers)} KEGG prompts, 32 greedy "
        f"tokens, in {secs * 1e3:.1f} ms; launches {got}; first answer {answers[0][:60]!r}")
    if (len(answers) != FP32_API_PROMPTS or got.get("flash_f32_fwd") != DECODER_LAYERS
            or any(v for kk, v in got.items() if kk != "flash_f32_fwd")):
        fail(f"fp32 (c): DnaLLM.generate_text gave {len(answers)} answers, launched {got}")
    out["api"] = {"s": secs, "launches": got}
    del api, model
    torch.cuda.empty_cache()

    # (d) make_traces --backend engine on 4 variant rows: bf16 int8 serving
    # storage (its default), one engine call, the decoder prefill's 28 flash_fwd
    tmp = tempfile.mkdtemp(prefix="smoke_traces_", dir=build_dir)
    try:
        tsv = os.path.join(tmp, "v.tsv")
        cols = ["Var_ID", "ENTRY", "Chr", "Start", "RefAllele", "AltAllele",
                "Network Definition", "Gene", "Disease"]
        with open(tsv, "w") as f:
            f.write("\t".join(cols) + "\n")
            for i in range(FP32_TRACE_ITEMS):
                f.write("\t".join([f"rs{i}", "hsa:3845", "12", str(25245350 + i), "C", "T",
                                   "EGFR-RAS-RAF-MEK-ERK signaling",
                                   json.dumps({"hsa:3845": "KRAS; KRAS proto-oncogene"}),
                                   json.dumps({"Pancreatic cancer": "H00018"})]) + "\n")
        reset_counts()
        t0 = time.perf_counter()
        analyses = make_traces.main(["--tsv", tsv, "--out", os.path.join(tmp, "a.json"),
                                     "--backend", "engine", "--encoder", "nt-50m",
                                     "--max_new_tokens", "64", "--batch_size", "8",
                                     "--device", DEV])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = all_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kinds = sorted({a["backend"] for a in analyses})
    log(f"fp32 (d) make_traces --backend engine [{card}]: {len(analyses)} analyses ({kinds}) "
        f"in {secs:.2f} s (model build included); launches {got}")
    if (len(analyses) != FP32_TRACE_ITEMS or got.get("flash_fwd") != DECODER_LAYERS
            or any(v for kk, v in got.items() if kk != "flash_fwd")):
        fail(f"fp32 (d): make_traces wrote {len(analyses)} analyses, launched {got}")
    out["traces"] = {"s": secs, "launches": got, "backends": kinds}
    secs = time.perf_counter() - t_phase
    log(f"fp32: {secs:.1f} s of the script's clock (budget {FP32_API_BUDGET_S:.0f} s)")
    out["s"] = secs
    return out


# -- main ---------------------------------------------------------------------

# -- phases 20-23: multi-device on one card ------------------------------------
#
# 20 (mesh): a real NCCL group of one rank and the trainer's mesh code path
# at bench.py's shape; 21 (sp) and 22 (pp): two ranks in two processes
# sharing the card over gloo (NCCL refuses two ranks on one card), each
# rank's kernels at the shapes a world of 2 gives them; 23 (grpo_learns):
# the rigged-reward GRPO check through the kernels. Nothing across cards
# is measured here: one card has no NVLink peer.

MESH_STEPS = 3
MESH_LOSS_RTOL, MESH_NORM_RTOL = 2e-3, 2e-2   # flash_bwd's dq sums in no fixed order
SP_COS = 0.99                                 # kernel frames vs one-device kernel, bf16
PP_MICRO = 4
GRPO_LEARN_STEPS = 30


def _store(tag):
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    return os.path.join(tempfile.mkdtemp(prefix=f"smoke_{tag}_", dir=build_dir), "store")


def _cos(torch, a, b):
    """Cosine of two tensors, in fp64 (an fp32 dot of tens of millions of
    gradients reads above 1)."""
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-30))


def phase_mesh(torch, card):
    """(20) A world of one rank over NCCL: the collectives the mesh code
    uses on CUDA tensors, then SFTTrainer(mesh=make_mesh(MeshConfig())) at
    bench.py's shape for MESH_STEPS steps beside the one-device trainer on
    the same weights and batches (loss within MESH_LOSS_RTOL, grad-norm
    within MESH_NORM_RTOL)."""
    import torch.distributed as dist
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, MeshConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    from bioreason_tpu_torch.train.sft import SFTTrainer
    dist.init_process_group("nccl", init_method=f"file://{_store('mesh')}", rank=0,
                            world_size=1)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y)
        g = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(g, x)
        r = torch.empty(8, device="cuda")
        dist.reduce_scatter_tensor(r, x)
        dist.broadcast(y, src=0)
        if not all(torch.equal(t, x) for t in (y, g, r)):
            fail("NCCL collectives of one rank did not return their input")
        log(f"mesh [{card}]: NCCL world of 1 ({dist.get_backend()}): all_reduce, "
            f"all_gather_into_tensor, reduce_scatter_tensor, broadcast on CUDA tensors")
        dec = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
        enc = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
        cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=151938)
        sft = SFTConfig(batch_size=4, lora=LoRAConfig(r=32, alpha=64, dropout=0.0),
                        optim=OptimConfig(total_steps=100, warmup_ratio=0.0), seed=0)
        batch = bench_batch(cfg)
        out = {}
        for label, mesh in (("one_device", None), ("mesh", make_mesh(MeshConfig()))):
            trainer = SFTTrainer(cfg, sft, mesh=mesh)
            trainer.train_step(batch)                    # warm-up (not compared)
            torch.cuda.synchronize()
            reset_counts()
            ms, metrics = [], []
            for _ in range(MESH_STEPS):
                t0 = time.perf_counter()
                metrics.append(trainer.train_step(batch))
                ms.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            out[label] = {"metrics": metrics, "ms": ms, "launches": got,
                          "dist_opt": type(trainer.opt).__name__}
            log(f"mesh: {label} trainer ({out[label]['dist_opt']}): step ms "
                f"{[round(v, 1) for v in ms]}, losses "
                f"{[round(m['loss'], 5) for m in metrics]}, grad norms "
                f"{[round(m['grad_norm'], 5) for m in metrics]}; launches {got}")
            del trainer
            torch.cuda.empty_cache()
        for a, b in zip(out["mesh"]["metrics"], out["one_device"]["metrics"]):
            if not (math.isclose(a["loss"], b["loss"], rel_tol=MESH_LOSS_RTOL)
                    and math.isclose(a["grad_norm"], b["grad_norm"], rel_tol=MESH_NORM_RTOL)):
                fail(f"the mesh trainer's step {a} differs from the one-device {b}")
        if out["mesh"]["dist_opt"] != "DistAdamW":
            fail("the mesh trainer did not take the mesh code path")
        got = out["mesh"]["launches"]
        if got["flash_fwd"] == 0 or got["flash_bwd"] == 0 or got != out["one_device"]["launches"]:
            fail(f"the mesh trainer's launches {got} are not the one-device trainer's "
                 f"{out['one_device']['launches']}")
        return out
    finally:
        dist.destroy_process_group()


def _sp_long(torch, mesh, axis):
    """(21a) The long-DNA SFT step of phase 7 (2 x 12 kb, NT-v2-500M
    finetuned, W=256) on sp_local:256: loss and gradients; rank 0 then
    runs the one-device local:256 step and compares."""
    from bioreason_tpu_torch.config import LoRAConfig, OptimConfig, SFTConfig
    from bioreason_tpu_torch.serve import build_config
    from bioreason_tpu_torch.train.sft import SFTTrainer
    import torch.distributed as dist
    cfg, _ = build_config("qwen3-0.6b", "nt-500m", max_length_dna=2048)
    sft = SFTConfig(batch_size=2, lora=LoRAConfig(r=32, alpha=64, dropout=0.0),
                    freeze_encoder=False, optim=OptimConfig(total_steps=10), seed=0)
    batch = long_batch(long_items())

    def loss_grads(impl, mesh):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                 attention_impl=impl))
        tr = SFTTrainer(c, sft, mesh=mesh)
        db = tr._device_batch(batch)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(db)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        t0 = time.perf_counter()
        if mesh is not None:
            grads = tr.opt.reduce(grads)                 # summed over the ranks
            loss = tr.run.sum_dp(loss.detach())
        torch.cuda.synchronize()
        reduce_ms = (time.perf_counter() - t0) * 1e3
        enc = {n: g for n, g in zip(tr.names, grads) if n.startswith("encoder.")}
        return float(loss.detach()), enc, got, ms, reduce_ms

    loss, enc, got, ms, reduce_ms = loss_grads(f"sp_local:{LONG_WINDOW}", mesh)
    res = {"loss": loss, "launches": got, "ms": ms, "reduce_ms": reduce_ms}
    dist.barrier()
    if axis.index == 0:
        ref_loss, ref_enc, ref_got, ref_ms, _ = loss_grads(f"local:{LONG_WINDOW}", None)
        flat = lambda d: torch.cat([d[n].float().flatten() for n in sorted(d)])
        a, b = flat(enc), flat(ref_enc)
        res.update(ref_loss=ref_loss, ref_launches=ref_got, ref_ms=ref_ms, cos=_cos(torch, a, b),
                   rel_l2=float((a - b).norm() / b.norm()), n_leaves=len(enc))
        del ref_enc
    del enc
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def _sp_encoder(torch, axis):
    """(21b) The NT-v2-500M encoder forward on sp_pallas over the long
    batch's 4 x 2049 tokens; rank 0 compares with the one-device kernel."""
    import torch.distributed as dist
    from bioreason_tpu_torch.cli.common import build_encoder_config
    from bioreason_tpu_torch.models.layers import init_normal_
    from bioreason_tpu_torch.models.nt_encoder import NTEncoder, encoder_forward
    from bioreason_tpu_torch.parallel.sp import sequence_sharding
    from bioreason_tpu_torch.utils.devices import torch_dtype
    _, enc_cfg, _, _ = build_encoder_config("nt-500m")
    batch = long_batch(long_items())
    ids = torch.as_tensor(batch["dna_input_ids"], device="cuda")
    mask = torch.as_tensor(batch["dna_attention_mask"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tower = init_normal_(NTEncoder(enc_cfg, "cuda", torch_dtype(enc_cfg.dtype)), gen)
    res = {"shape": list(ids.shape)}
    with torch.no_grad():
        cfg = dataclasses.replace(enc_cfg, attention_impl="sp_pallas")
        reset_counts()
        t0 = time.perf_counter()
        with sequence_sharding(axis):
            h = encoder_forward(tower, cfg, ids, mask)
        torch.cuda.synchronize()
        res.update(ms=(time.perf_counter() - t0) * 1e3, launches=counts())
        if axis.index == 0:
            ref = encoder_forward(tower, dataclasses.replace(enc_cfg, attention_impl="pallas"),
                                  ids, mask)
            valid = mask.bool()
            a, b = h.float()[valid], ref.float()[valid]
            res.update(cos=_cos(torch, a, b), max_abs_err=float((a - b).abs().max()),
                       max_ref=float(b.abs().max()))
    del tower
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def _sp_evo2(torch, axis):
    """(21c) The Evo2-1B tower forward on phase 9's served DNA with sp:
    rank 1's causal attention runs flash_fwd at q_offset = chunk; rank 0
    compares with the one-device tower."""
    import torch.distributed as dist
    from bioreason_tpu_torch.models.evo2 import hyena_forward, init_hyena
    from bioreason_tpu_torch.parallel.sp import sequence_sharding
    from bioreason_tpu_torch.serve import build_config
    cfg, _ = build_config("qwen3-0.6b", "evo2-1b", max_length_dna=EVO2_BP)
    _, (_, _, dna, dmask) = evo2_served_inputs()
    ids = torch.as_tensor(dna, device="cuda")
    mask = torch.as_tensor(dmask, device="cuda")
    tower = init_hyena(cfg.hyena, seed=0, device="cuda")
    res = {"shape": list(ids.shape)}
    with torch.no_grad():
        reset_counts()
        t0 = time.perf_counter()
        with sequence_sharding(axis):
            h = hyena_forward(tower, dataclasses.replace(cfg.hyena, attention_impl="sp"),
                              ids, mask)
        torch.cuda.synchronize()
        res.update(ms=(time.perf_counter() - t0) * 1e3, launches=counts())
        if axis.index == 0:
            ref = hyena_forward(tower, cfg.hyena, ids, mask)
            valid = mask.bool()
            a, b = h.float()[valid], ref.float()[valid]
            res.update(cos=_cos(torch, a, b), max_abs_err=float((a - b).abs().max()),
                       max_ref=float(b.abs().max()))
    del tower
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def _pp_stage(torch, axis):
    """(22) Qwen3-0.6B's 28 layers as 2 GPipe stages of 14 with M=PP_MICRO
    at bench.py's shape (B=4, T=768, the last 128 positions supervised),
    LoRA r32 with nonzero B: the loss and this stage's LoRA gradients
    against the plain decoder_forward on the same rank."""
    import torch.distributed as dist
    from bioreason_tpu_torch.config import DecoderConfig, LoRAConfig
    from bioreason_tpu_torch.models.layers import init_normal_
    from bioreason_tpu_torch.models.qwen3 import Qwen3Decoder, decoder_forward
    from bioreason_tpu_torch.ops.fused_ce import decoder_lm_loss
    from bioreason_tpu_torch.parallel.pp import pipeline_sharding
    from bioreason_tpu_torch.train.lora import attach_lora
    cfg = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = init_normal_(Qwen3Decoder(cfg, "cuda", torch.bfloat16), gen)
    attach_lora(dec, LoRAConfig(r=32, alpha=64, dropout=0.0), gen)
    for n, p in dec.named_parameters():
        p.requires_grad_(n.endswith(("lora_a", "lora_b")))
        if n.endswith("lora_b"):
            with torch.no_grad():
                p.normal_(0, 0.01, generator=gen)
    npr = np.random.default_rng(0)
    ids = torch.as_tensor(npr.integers(0, 150000, (4, 768)), device="cuda")
    labels = torch.where(torch.arange(768, device="cuda")[None] >= 640, ids, -100)
    s = cfg.num_layers // axis.size
    own = range(axis.index * s, (axis.index + 1) * s)
    names = [n for n, p in dec.named_parameters()
             if p.requires_grad and int(n.split(".")[1]) in own]
    params = [dict(dec.named_parameters())[n] for n in names]

    def run(pipelined):
        scope = (pipeline_sharding(axis, PP_MICRO, layers=own) if pipelined
                 else pipeline_sharding(None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scope:
            h, _ = decoder_forward(dec, cfg, ids, return_hidden=True)
        loss = decoder_lm_loss(h.to(torch.bfloat16), dec.embed.weight, labels)
        last = not pipelined or axis.index == axis.size - 1
        grads = torch.autograd.grad(loss if last else loss * 0.0, params, allow_unused=True)
        torch.cuda.synchronize()
        return float(loss.detach()), grads, (time.perf_counter() - t0) * 1e3

    run(True)                                            # warm-up
    reset_counts()
    loss, grads, ms = run(True)
    got = counts()
    ref_loss, ref_grads, ref_ms = run(False)
    flat = lambda gs: torch.cat([g.float().flatten() for g in gs])
    a, b = flat(grads), flat(ref_grads)
    res = {"loss": loss, "ref_loss": ref_loss, "ms": ms, "ref_ms": ref_ms, "launches": got,
           "cos": _cos(torch, a, b), "rel_l2": float((a - b).norm() / b.norm()),
           "n_lora": len(params), "layers": [own.start, own.stop]}
    del dec, grads, ref_grads
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def _two_rank_world(rank, world, store, queue):
    """One of the two processes of phases 21-22: rank `rank` on cuda:0."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        from bioreason_tpu_torch.config import MeshConfig
        from bioreason_tpu_torch.parallel.mesh import make_mesh, topology
        mesh = make_mesh(MeshConfig(data=1, fsdp=1, model=world), device="cuda")
        axis = topology(mesh).model
        out = {}
        for name, fn in (("sp_long", lambda: _sp_long(torch, mesh, axis)),
                         ("sp_encoder", lambda: _sp_encoder(torch, axis)),
                         ("sp_evo2", lambda: _sp_evo2(torch, axis)),
                         ("pp", lambda: _pp_stage(torch, axis))):
            t0 = time.perf_counter()
            out[name] = fn()
            out[name]["seconds"] = round(time.perf_counter() - t0, 1)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        import traceback
        queue.put((rank, None, traceback.format_exc()))


# one rank of the probe: a gloo group of two processes on cuda:0 running
# one collective natively on CUDA tensors and checking its values
GLOO_PROBE = r"""
import sys, torch, torch.distributed as dist
rank, op, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
x = torch.arange(4, dtype=torch.float32, device="cuda") + rank
base = torch.arange(4, dtype=torch.float32, device="cuda")
if op == "all_reduce":
    dist.all_reduce(x); want = 2 * base + 1
elif op == "all_gather":
    y = torch.empty(8, device="cuda"); dist.all_gather_into_tensor(y, x)
    x, want = y, torch.cat([base, base + 1])
elif op == "reduce_scatter":
    y = torch.empty(2, device="cuda"); dist.reduce_scatter_tensor(y, x)
    x, want = y, (2 * base + 1)[2 * rank:2 * rank + 2]
elif op == "broadcast":
    dist.broadcast(x, src=0); want = base
else:
    if rank == 0:
        dist.send(x, 1); want = base
    else:
        dist.recv(x, 0); want = base
torch.cuda.synchronize()
print("ok" if torch.equal(x, want) else "wrong values", flush=True)
"""


def gloo_cuda_probe():
    """Which collectives gloo takes on CUDA tensors between two processes on
    the card: each op in its own pair of processes (a native gloo send of
    a CUDA tensor can abort the process), all pairs at once. Returns op ->
    'native' or what refused it; recorded in PERF.md. `comm.GLOO_CUDA_STAGED`
    must name every op gloo refuses (the script fails otherwise)."""
    ops = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "p2p")
    procs = {}
    for op in ops:
        store = _store(f"probe_{op}")
        procs[op] = [subprocess.Popen([sys.executable, "-c", GLOO_PROBE, str(r), op, store],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for r in range(2)]
    out = {}
    for op, pair in procs.items():
        texts = []
        for p in pair:
            try:
                so, se = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                se = "hung (killed after 180 s)"
            texts.append((p.returncode, so.strip(), se.strip()))
        if all(rc == 0 and so == "ok" for rc, so, _ in texts):
            out[op] = "native"
        else:
            rc, so, se = next(t for t in texts if not (t[0] == 0 and t[1] == "ok"))
            last = [ln for ln in (se or so).splitlines() if ln.strip()][-1:] or [""]
            out[op] = f"refused (exit {rc}): {last[0][:160]}"
    return out


def phase_two_ranks(torch, card):
    """(21, 22) Two processes on the one card over gloo (module note above):
    sequence parallelism (a) long-DNA SFT on sp_local:256, (b) NT-v2-500M on
    sp_pallas, (c) Evo2-1B on sp; then GPipe over two stages."""
    import multiprocessing as mp
    from bioreason_tpu_torch.parallel.comm import GLOO_CUDA_STAGED
    probe = gloo_cuda_probe()
    log(f"sp/pp [{card}]: gloo on CUDA tensors between two processes: {probe}; staged "
        f"through host memory by the port: {sorted(GLOO_CUDA_STAGED)}")
    unstaged = [op for op, v in probe.items() if v != "native" and op not in GLOO_CUDA_STAGED]
    if unstaged:
        fail(f"gloo refuses {unstaged} on CUDA tensors, which the port does not stage")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = _store("two")
    procs = [ctx.Process(target=_two_rank_world, args=(r, 2, store, queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = [None, None]
    t0 = time.perf_counter()
    try:
        while None in results:
            try:
                rank, out, err = queue.get(timeout=5)
            except Exception:                    # queue.Empty: is every rank alive?
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() - t0 > 900:
                    fail(f"the two-rank world died or hung (exit codes "
                         f"{[p.exitcode for p in procs]}; its stderr is above)")
                continue
            if err is not None:
                fail(f"rank {rank} of the two-rank world raised:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    r0, r1 = results
    # (a)
    a0, a1 = r0["sp_long"], r1["sp_long"]
    log(f"sp (a) long-DNA SFT step, sp_local:{LONG_WINDOW} over 2 ranks: loss {a0['loss']:.6f} "
        f"vs one-device local:{LONG_WINDOW} {a0['ref_loss']:.6f}; the {a0['n_leaves']} encoder "
        f"gradients: cosine {a0['cos']:.6f}, relative L2 {a0['rel_l2']:.4g}; forward+backward ms "
        f"rank 0 {a0['ms']:.1f}, rank 1 {a1['ms']:.1f}, one device {a0['ref_ms']:.1f}; the "
        f"gradients' sum over the ranks (gloo) ms {a0['reduce_ms']:.1f}; launches "
        f"rank 0 {a0['launches']}, rank 1 {a1['launches']}, one device {a0['ref_launches']}")
    if not math.isclose(a0["loss"], a0["ref_loss"], rel_tol=MESH_LOSS_RTOL) or a0["cos"] < SP_COS:
        fail(f"sp_local:{LONG_WINDOW} disagrees with local:{LONG_WINDOW}: {a0}")
    for r in (a0, a1):
        if r["launches"]["local_fwd"] == 0 or r["launches"]["local_bwd"] == 0:
            fail(f"a rank ran no local_fwd / local_bwd on its halo frame: {r['launches']}")
    # (b), (c)
    for key, label in (("sp_encoder", "(b) NT-v2-500M encoder, sp_pallas"),
                       ("sp_evo2", "(c) Evo2-1B tower, sp")):
        x0, x1 = r0[key], r1[key]
        log(f"sp {label}, DNA {x0['shape']}: cosine to one device {x0['cos']:.6f}, max abs "
            f"err {x0['max_abs_err']:.4g} (max |ref| {x0['max_ref']:.4g}); forward ms rank 0 "
            f"{x0['ms']:.1f}, rank 1 {x1['ms']:.1f}; launches rank 0 {x0['launches']}, "
            f"rank 1 {x1['launches']}")
        if x0["cos"] < SP_COS:
            fail(f"sp {label} disagrees with one device: cosine {x0['cos']}")
        if x0["launches"]["flash_fwd"] == 0 or x1["launches"]["flash_fwd"] == 0:
            fail(f"sp {label}: a rank launched no flash_fwd")
    # (22)
    p0, p1 = r0["pp"], r1["pp"]
    for st, r in enumerate((p0, p1)):
        log(f"pp stage {st} (layers {r['layers']}), M={PP_MICRO}: loss {r['loss']:.6f} vs "
            f"plain {r['ref_loss']:.6f}; its {r['n_lora']} LoRA gradients: cosine "
            f"{r['cos']:.6f}, relative L2 {r['rel_l2']:.4g}; step ms {r['ms']:.1f} (plain "
            f"decoder on one rank {r['ref_ms']:.1f}); launches {r['launches']}")
        if (not math.isclose(r["loss"], r["ref_loss"], rel_tol=MESH_LOSS_RTOL)
                or r["cos"] < SP_COS):
            fail(f"pp stage {st} disagrees with the plain decoder: {r}")
        if r["launches"]["flash_fwd"] == 0 or r["launches"]["flash_bwd"] == 0:
            fail(f"pp stage {st} launched no flash_fwd / flash_bwd: {r['launches']}")
    log(f"sp/pp: seconds by part, rank 0 "
        f"{ {k: v['seconds'] for k, v in r0.items()} }, rank 1 "
        f"{ {k: v['seconds'] for k, v in r1.items()} }")
    return {"probe": probe, "ranks": results}


def sp_kernel_cases(torch):
    """The kernels at the per-rank shapes of a world of 2: Evo2-1B's causal
    rank 1 (q_offset = chunk), NT-v2-500M's sp_pallas rank, the halo-framed
    band of sp_local:256 and the gather fallback's zero-padded frame."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    t = EVO2_BP
    c = t // 2
    rows = [kernel_case(torch, f"sp_rank1_evo2_causal_q{c}_k{t}", 16, c, t, 15, 15, 128, True,
                        c, right_padded(torch, 16, t, t - 64, gen), 16),
            kernel_case(torch, "sp_rank0_nt500m_q1025_k2050", 4, 1025, 2050, 16, 16, 64, False,
                        None, right_padded(torch, 4, 2050, 1900, gen), 17)]
    halo = torch.ones((4, 1025 + 2 * LONG_WINDOW), dtype=torch.int32, device="cuda")
    halo[:, :LONG_WINDOW] = 0                             # rank 0: nothing on its left
    band = [local_case(torch, f"sp_local_halo_frame_T{1025 + 2 * LONG_WINDOW}", 4,
                       1025 + 2 * LONG_WINDOW, 16, 16, 64, LONG_WINDOW, halo, 18),
            local_case(torch, "sp_local_gather_T384", 4, 384, 16, 16, 64, LONG_WINDOW,
                       right_padded(torch, 4, 384, 300, gen), 19)]
    return rows, [r for pair in band for r in pair]


def phase_grpo_learns(torch, card):
    """(23) tests/test_torch_grpo_learning_slow.py on the card: the tiny
    fusion (decoder head dim 64 in bf16 on 'auto', so prefill, logp and
    update passes take flash_fwd / flash_bwd), the reward min(count('a'),
    8) / 4, 30 steps; the last 5 steps' mean reward must exceed 1.5x the
    first 5's."""
    from bioreason_tpu_torch.config import (DecoderConfig, FusionConfig, GRPOConfig,
                                            OptimConfig, SamplingConfig)
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    tok = ByteTextTokenizer()
    fusion = FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    fusion = dataclasses.replace(fusion, decoder=dataclasses.replace(
        fusion.decoder, head_dim=64, dtype="bfloat16", attention_impl="auto"))
    cfg = GRPOConfig(num_generations=4, batch_size=8, beta=0.0, num_iterations=1,
                     max_completion_length=16,
                     sampling=SamplingConfig(temperature=1.0, top_k=40, top_p=1.0,
                                             max_new_tokens=16),
                     optim=OptimConfig(learning_rate=3e-3, total_steps=40, warmup_ratio=0.0),
                     lora=None, seed=0)

    def letter_reward(prompts, completions, answer=None, **kw):
        return [min(c.count("a"), 8) / 4.0 for c in completions]
    trainer = GRPOTrainer(fusion, cfg, BioProcessor(tok, KmerTokenizer()), [letter_reward])
    prompts = [format_kegg_prompt_only(it) for it in synthetic_kegg_items(2, seq_len=24)]
    items = [p for p in prompts for _ in range(4)]
    reset_counts()
    t0 = time.perf_counter()
    rewards = [trainer.step(items)["reward"] for _ in range(GRPO_LEARN_STEPS)]
    dt = time.perf_counter() - t0
    got = all_counts()
    early, late = float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))
    log(f"grpo_learns [{card}]: {GRPO_LEARN_STEPS} steps in {dt:.1f} s; mean reward first 5 "
        f"{early:.4f}, last 5 {late:.4f}; rewards {[round(r, 3) for r in rewards]}; "
        f"launches {got}")
    if got["flash_fwd"] == 0 or got["flash_bwd"] == 0:
        fail(f"the GRPO learning check ran no flash_fwd / flash_bwd: {got}")
    if not late > 1.5 * early:
        fail(f"GRPO did not learn the rigged reward on the card: {early} -> {late}")
    return {"early": early, "late": late, "launches": got, "seconds": dt}


# -- phase 24: generation and GRPO under the 'model' axis ------------------------
#
# Two processes share the card over gloo as phases 21-22 do, in a mesh
# (1, 1, 2): the decoder's and the NT encoder's layers split their heads and
# MLP rows over the two ranks, the engine's caches hold Hkv/2 heads, GRPO
# rolls out, scores and updates on those shards, and the DNA-only classifier
# trains its encoder on them; (f)-(g) run QLoRA on the mesh, (h) bf16
# LoRA SFT with the 151,936-row vocabulary table split and (i) the same
# SFT on the mesh (1, 2, 1), every fsdp leaf gathered one layer at a time.
# Rank 0 also holds the one-device model from the same seed and compares;
# rank 1 waits at a barrier meanwhile.

TP_PROMPTS, TP_NEW = 8, 8            # (a): 8 prompts, greedy, 8 new tokens (cut from 32)
TP_GRPO_STEPS = 1                    # (c), (f): timed, no warm-up step (cut from 1 + 2)
TP_CLS_STEPS = 2                     # (e): the classifier's steps on phase 13's batch
TP_SFT_STEPS = 2                     # (g), (h), (i): SFT steps at bench.py's shape
TP_HANG_S = 600


def _tp_record_shapes():
    """Count flash_fwd / flash_bwd launches in this process by their
    (B, Tq, Tk, Hq, Hkv, D), read from the arguments the wrappers hand the
    kernels (the counts the wrappers keep are unchanged)."""
    from bioreason_tpu_torch.ops import flash_attention as fa
    seen = {"flash_fwd": {}, "flash_bwd": {}}
    real = fa.kernel_fn

    def kernel_fn(entry):
        fn = real(entry)
        if entry not in seen:
            return fn
        lo = 6 if entry == "flash_fwd" else 13

        def call(*a):
            key = tuple(int(x) for x in a[lo:lo + 6])
            seen[entry][key] = seen[entry].get(key, 0) + 1
            return fn(*a)
        return call
    fa.kernel_fn = kernel_fn
    return seen


def _tp_engine_call(torch, engine, model, out, seen, group, new, forced=None, **kw):
    """One engine call: the ids, every logit row it sampled from (fp32 on
    the card), the bytes of the caches it made, flash_fwd's launches and
    their shapes, and its ms. `forced` [B*G, new] replaces each step's
    sampled ids (teacher forcing on a given stream)."""
    from bioreason_tpu_torch.generate import engine as E
    rows, nbytes = [], [0]
    real_sample, real_init = E.sample_logits, E.init_cache

    def sample(logits, *a, **k):
        tok = real_sample(logits, *a, **k)
        step = len(rows)
        rows.append(logits.float().clone())
        return tok if forced is None else forced[:, step].to(tok.dtype)

    def init(*a, **k):
        cache = real_init(*a, **k)
        nbytes[0] += sum(t.numel() * t.element_size() for e in cache for t in e.values())
        return cache
    E.sample_logits, E.init_cache = sample, init
    try:
        torch.cuda.synchronize()
        reset_counts()
        for d in seen.values():
            d.clear()
        t0 = time.perf_counter()
        ids, _ = engine.generate(model, out.input_ids, out.attention_mask, out.dna_input_ids,
                                 out.dna_attention_mask, max_new_tokens=new,
                                 group_size=group, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        E.sample_logits, E.init_cache = real_sample, real_init
    return {"ids": ids, "rows": rows, "cache_bytes": nbytes[0], "ms": ms,
            "launches": counts()["flash_fwd"], "shapes": dict(seen["flash_fwd"])}


def _tp_cos_floor(torch, got, want):
    """The lowest cosine over (step, row) of two lists of [B, V] logits."""
    a, b = torch.stack(got), torch.stack(want)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def _tp_engine_checks(torch, dist, axis, tp, one, out, seen, group, new, label):
    """(a) / (b) on one rank: the one-device greedy call (rank 0), then the
    tensor-parallel call teacher-forced on its stream (broadcast to rank 1),
    whose first logit rows give the ranks' first greedy tokens."""
    res = {}
    ref = [None]
    if axis.index == 0:
        r1 = _tp_engine_call(torch, one.engine, one.model, out, seen, group, new, greedy=True)
        ref = [r1["ids"]]
        res.update(one_ms=r1["ms"], one_cache_bytes=r1["cache_bytes"],
                   one_launches=r1["launches"])
    dist.barrier()
    dist.broadcast_object_list(ref, src=0)
    forced = torch.as_tensor(ref[0], device="cuda")
    tf = _tp_engine_call(torch, tp.engine, tp.model, out, seen, group, new, forced=forced,
                         greedy=True)
    res.update(ms=tf["ms"], cache_bytes=tf["cache_bytes"], launches=tf["launches"],
               shapes=tf["shapes"], first=tf["rows"][0].argmax(-1).cpu().numpy())
    if axis.index == 0:
        res["cos"] = _tp_cos_floor(torch, tf["rows"], r1["rows"])
        res["one_first"] = r1["ids"][:, 0]
        gap = r1["rows"][0].topk(2, dim=-1).values
        res["one_top2_gap"] = float((gap[:, 0] - gap[:, 1]).min())
    log(f"tp ({label}) rank {axis.index}: engine call {tf['ms']:.1f} ms "
        f"(one device {res.get('one_ms', float('nan')):.1f}), cache {tf['cache_bytes']} B, "
        f"flash_fwd {tf['launches']} at {tf['shapes']}")
    return res


def _tp_grpo_step(torch, dist, axis, tp, one, items, seen, part):
    """(24c) / (24f) on one rank: TP_GRPO_STEPS timed steps of the mesh
    trainer `tp` (the engine and its kernels warm), their launches and
    shapes, the LoRA B leaves moved, then one update on the last rollout
    buffer: its loss and whole LoRA gradients, held on rank 0 against the
    one-device trainer `one` set to the same adapters."""
    b0 = {k: v.clone() for k, v in tp.trainable_state().items() if k.endswith("lora_b")}
    hist = []
    reset_counts()
    for d in seen.values():
        d.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    completions = []
    for _ in range(TP_GRPO_STEPS):
        hist.append(tp.step(items))
        completions.append(list(tp.last_completions))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TP_GRPO_STEPS
    got = counts()
    shapes = {k: dict(v) for k, v in seen.items()}
    state = tp.trainable_state()                 # whole, gathered from both ranks
    moved = [k for k, v in b0.items() if not torch.equal(state[k], v)]
    res = {"hist": hist, "step_ms": step_ms, "launches": got, "shapes": shapes,
           "moved": len(moved), "n_b": len(b0), "completions": completions,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    # one update on the last rollout buffer: loss and the whole gradients
    buf = tp._buffers[0]
    loss, _, _ = tp._loss(buf["batch"], buf["completion_len"])
    grads = torch.autograd.grad(loss, tp.params, allow_unused=True)
    whole = {n: tp.run.plan.unshard(n, torch.zeros_like(p) if g is None else g)
             for n, p, g in zip(tp.names, tp.params, grads) if "lora_" in n}
    res["update_loss"] = float(loss.detach())
    part("steps_update")
    del grads
    dist.barrier()
    if axis.index == 0:
        with torch.no_grad():
            for n, p in zip(one.names, one.params):
                p.copy_(state[n].to(p.device, p.dtype))
        ref_loss, _, _ = one._loss(buf["batch"], buf["completion_len"])
        ref_grads = dict(zip(one.names, torch.autograd.grad(ref_loss, one.params,
                                                            allow_unused=True)))
        names = sorted(whole)
        flat = lambda d: torch.cat([(torch.zeros_like(whole[n]) if d[n] is None else d[n])
                                    .float().flatten() for n in names])
        a, b = flat(whole), flat(ref_grads)
        # the loss is -mean(advantage) (0 per group by construction; the ratio
        # is exactly 1) + beta * kl: its error is held against the size of the
        # terms that cancel in it
        res.update(ref_loss=float(ref_loss.detach()), cos=_cos(torch, a, b),
                   rel_l2=float((a - b).norm() / b.norm()), n_lora=len(names),
                   loss_scale=float(buf["batch"]["advantages"].abs().mean()))
        part("one_device_update")
        del ref_grads, a, b
    del whole, buf
    return res


def _int8_bytes(model):
    """Bytes of the int8 weights and scales `model` holds."""
    from bioreason_tpu_torch.parallel.partition import int8_buffers
    return sum(t.numel() * t.element_size() for t in int8_buffers(model).values())


def _tp_rank(torch, mesh, axis, one_step_ms):
    """Phase 24 on one rank (module note above the constants). Rank 0 times
    the one-device trainer's steps unless `one_step_ms` (phase 8's, the same
    configuration in this run) is given."""
    import types

    import torch.distributed as dist
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.train.grpo import GRPOTrainer
    from bioreason_tpu_torch.train.rewards import get_reward_funcs
    seen = _tp_record_shapes()
    cfg, gcfg, proc, items = grpo_setup()
    # no warm-up in the schedule: the one step of (c) moves the adapters
    gcfg = dataclasses.replace(gcfg, optim=dataclasses.replace(gcfg.optim, warmup_ratio=0.0))
    rewards = get_reward_funcs(["xmlcount", "correctness"]) + [acgt_share_reward]
    t_rank = time.perf_counter()
    tp = GRPOTrainer(cfg, gcfg, proc, rewards, mesh=mesh)
    one = GRPOTrainer(cfg, gcfg, proc, rewards) if axis.index == 0 else None
    parts = {}
    res = {"parts": parts}

    def part(name):
        """Seconds since the previous part."""
        torch.cuda.synchronize()
        parts[name] = round(time.perf_counter() - t_rank - sum(parts.values()), 1)
    part("build")
    # (a) 8 prompts, greedy, ungrouped
    served = [format_kegg_prompt_only(it)
              for it in synthetic_kegg_items(TP_PROMPTS, seq_len=600, seed=1)]
    out_a, _ = tp._prepare_prompts(served)
    res["a"] = _tp_engine_checks(torch, dist, axis, tp, one, out_a, seen, 1, TP_NEW, "a")
    part("a")
    # (b) the grouped rollout at GRPO's shape, greedy
    out_b, _ = tp._prepare_prompts(items[::GRPO_G])
    res["b"] = _tp_engine_checks(torch, dist, axis, tp, one, out_b, seen, GRPO_G, GRPO_NEW,
                                 "b")
    res["b"]["prompt_mask"] = np.asarray(out_b.attention_mask)
    part("b")
    # (c) GRPOTrainer(mesh): TP_GRPO_STEPS timed steps, the engine and its
    # kernels warm from (a) and (b)
    res["c"] = _tp_grpo_step(torch, dist, axis, tp, one, items, seen,
                             lambda name: part(f"c_{name}"))
    c = res["c"]
    log(f"tp (c) rank {axis.index}: GRPO step {c['step_ms']:.1f} ms over {TP_GRPO_STEPS} "
        f"steps; launches {c['launches']}; shapes {c['shapes']}")
    if axis.index == 0:
        c["one_step_ms"] = one_step_ms
        if one_step_ms is None:
            # warm already: its engine, model and kernels ran in (a), (b), above
            t0 = time.perf_counter()
            for _ in range(TP_GRPO_STEPS):
                one.step(items)
            torch.cuda.synchronize()
            c["one_step_ms"] = (time.perf_counter() - t0) * 1e3 / TP_GRPO_STEPS
            part("c_one_device_steps")
    del one, tp
    dist.barrier()
    torch.cuda.empty_cache()
    # (e) the DNA-only classifier, its encoder trained on the ranks' shards
    res["e"] = _tp_classifier(torch, dist, axis, mesh, seen)
    part("e")
    dist.barrier()
    torch.cuda.empty_cache()
    # (f) QLoRA GRPO with int8 rollouts and an int8 KV cache on the same mesh
    qcfg = dataclasses.replace(gcfg, frozen_dtype="int8", rollout_int8=True,
                               rollout_kv_int8=True)
    torch.cuda.reset_peak_memory_stats()
    tp = GRPOTrainer(cfg, qcfg, proc, rewards, mesh=mesh)
    one = GRPOTrainer(cfg, qcfg, proc, rewards) if axis.index == 0 else None
    roll = types.SimpleNamespace(engine=tp.engine, model=tp.rollout_model())
    one_roll = (types.SimpleNamespace(engine=one.engine, model=one.rollout_model())
                if one is not None else None)
    f = {"int8_bytes": _int8_bytes(tp.model), "rollout_int8_bytes": _int8_bytes(roll.model),
         "resident_gib": torch.cuda.memory_allocated() / 2**30}
    if one is not None:
        f.update(one_int8_bytes=_int8_bytes(one.model),
                 one_rollout_int8_bytes=_int8_bytes(one_roll.model))
    part("f_build")
    f["engine"] = _tp_engine_checks(torch, dist, axis, roll, one_roll, out_b, seen, GRPO_G,
                                    TP_NEW, "f")
    part("f_engine")
    del roll, one_roll
    f.update(_tp_grpo_step(torch, dist, axis, tp, one, items, seen,
                           lambda name: part(f"f_{name}")))
    if one is not None:                  # warm from its engine call and update
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.step(items)
        torch.cuda.synchronize()
        f["one_step_ms"] = (time.perf_counter() - t0) * 1e3
        part("f_one_device_step")
    log(f"tp (f) rank {axis.index}: QLoRA GRPO step {f['step_ms']:.1f} ms (one device "
        f"{f.get('one_step_ms', float('nan')):.1f}); launches {f['launches']}; shapes "
        f"{f['shapes']}; int8 bytes {f['int8_bytes']} (rollout {f['rollout_int8_bytes']}); "
        f"resident {f['resident_gib']:.3f} GiB, peak {f['peak_gib']:.3f} GiB")
    res["f"] = f
    del one, tp
    dist.barrier()
    torch.cuda.empty_cache()
    # (g) QLoRA SFT at bench.py's shape on a second mesh, (1, 2, 1)
    res["g"] = _tp_qlora_sft(torch, dist, axis, seen)
    part("g")
    dist.barrier()
    torch.cuda.empty_cache()
    # (h) bf16 LoRA SFT at bench.py's shape, the vocabulary table and the
    # projection split over 'model'
    keep = {}
    res["h"] = _tp_vocab_sft(torch, dist, axis, mesh, seen, keep)
    part("h")
    dist.barrier()
    torch.cuda.empty_cache()
    # (i) the same SFT on the mesh (1, 2, 1): the layers, tables, projection
    # and adapters gathered per layer; one device's run is (h)'s
    res["i"] = _tp_fsdp_sft(torch, dist, axis, seen, keep.get("grads"))
    part("i")
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def _tp_qlora_sft(torch, dist, axis, seen):
    """(24g) SFTTrainer(frozen_dtype="int8") at bench.py's shape on the mesh
    (1, 2, 1) of the same two processes (fsdp: each rank its 2 rows, the
    adapters sharded and gathered, the int8 weights whole on both) for
    TP_SFT_STEPS steps, beside the one-device QLoRA trainer on rank 0 from
    the same seed: each step's loss, grad-norm, ms and launches, the ranks'
    resident and peak GiB."""
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, MeshConfig, OptimConfig, SFTConfig)
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    from bioreason_tpu_torch.train.sft import SFTTrainer
    dec = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
    enc = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=151938)
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(r=32, alpha=64, dropout=0.0),
                    optim=OptimConfig(total_steps=100, warmup_ratio=0.0), frozen_dtype="int8",
                    seed=0)
    batch = bench_batch(cfg)
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, model=1), device="cuda")
    res = {}
    runs = [("mesh", mesh)] + ([("one", None)] if axis.index == 0 else [])
    for label, m in runs:
        torch.cuda.reset_peak_memory_stats()
        trainer = SFTTrainer(cfg, sft, mesh=m)
        r = {"resident_gib": torch.cuda.memory_allocated() / 2**30,
             "int8_bytes": _int8_bytes(trainer.model), "ms": [], "metrics": [],
             "launches": [], "shapes": []}
        for _ in range(TP_SFT_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            for d in seen.values():
                d.clear()
            t0 = time.perf_counter()
            r["metrics"].append(trainer.train_step(batch))
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["launches"].append(counts())
            r["shapes"].append({k: dict(v) for k, v in seen.items()})
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        r["fallback"] = trainer.run is None if m is not None else False
        res[label] = r
        del trainer
        torch.cuda.empty_cache()
        if label == "mesh":
            dist.barrier()
    log(f"tp (g) rank {axis.index}: QLoRA SFT at fsdp 2, step ms "
        f"{[round(x, 1) for x in res['mesh']['ms']]} (one device "
        f"{[round(x, 1) for x in res['one']['ms']] if 'one' in res else '-'}); losses "
        f"{[round(m['loss'], 5) for m in res['mesh']['metrics']]}; launches "
        f"{res['mesh']['launches']}; resident {res['mesh']['resident_gib']:.3f} GiB, peak "
        f"{res['mesh']['peak_gib']:.3f} GiB")
    return res


# (h): bf16 LoRA SFT at bench.py's shape with the 151,936-row vocabulary
# table, its head and the DNA projection split over 'model' (each rank
# V/2 table rows, H/2 projection rows). As for qlora (c): each gate sits
# between the noise floor (one device's first step against the same loss
# and gradients taken once more, through the kernels: flash_bwd's dq sums
# in no fixed order) and the reading of the planted fault named beside
# it, and the script fails where it does not part them. The mesh's
# readings are against one device's from the same seed.
H_LOSS_RTOL = 1e-3        # loss, both steps ("nomax")
H_NORM_RTOL = 5e-3        # grad norm, both steps ("nosum")
H_GRAD_COS = 0.999        # the first step's trainable gradients, cosine ("nosum")
H_LOGP_ATOL = 0.1         # per_token_logps of the first step's state, max |diff| ("nomax")
H_GATES = {"loss": ("nomax", H_LOSS_RTOL), "grad_norm": ("nosum", H_NORM_RTOL),
           "grad_cos": ("nosum", H_GRAD_COS), "logp": ("nomax", H_LOGP_ATOL)}
H_PROMPTS, H_PROMPT_TEXT, H_PROMPT_DNA, H_NEW = 8, 320, 64, 8


def _vocab_faults(torch):
    """Planted faults of the split CE and logp passes (ops/fused_ce.py):
    name -> (attribute, replacement, whether its reading takes the
    gradients). "offset": a rank's head rows read as the ids one past its
    own (rank 1's gold logits and one-hots shifted); "nomax": the ranks'
    sums of exp(logit - max) added without rescaling each to the global
    max; "nosum": the hidden state's gradient left a partial sum on each
    rank (no `comm.copy_to` before the head)."""
    from bioreason_tpu_torch.parallel import comm

    def offset(emb, axis):
        return 0 if axis is None else axis.index * (emb.shape[0] + 1)

    def nomax(m, s, gold, axis):
        ms, ss, golds = comm.all_gather(torch.stack([m, s, gold])[None], axis, 0).unbind(1)
        return ms.amax(0), ss.sum(0), golds.sum(0)
    return {"offset": ("_first_row", offset, False), "nomax": ("_combine", nomax, False),
            "nosum": ("_vocab_split", lambda hidden, axis: hidden, True)}


def _h_whole_grads(torch, trainer, grads):
    """The trainable gradients, whole, flattened in name order on the host
    (under a mesh from this rank's reduced shards: a collective)."""
    run = trainer.run
    whole = dict(zip(trainer.names, grads)) if run is None else {
        n: run.plan.unshard(n, g) for n, g in zip(trainer.names, grads)}
    return torch.cat([whole[n].float().flatten() for n in sorted(whole)]).cpu()


def _h_logps(torch, trainer, logp_args):
    from bioreason_tpu_torch.train.grpo import per_token_logps
    with torch.no_grad(), trainer.inference_scope():
        return per_token_logps(trainer.model, trainer.fusion_cfg, *logp_args).float().cpu()


def _h_reading(torch, trainer, db, logp_args, grads, logps=True):
    """A planted fault's (or the noise floor's) reading at the trainer's
    state: the loss, with `grads` the grad norm and the whole gradients
    (without the update), with `logps` the batch's per-token logps."""
    from bioreason_tpu_torch.train.optim import global_norm
    run, out = trainer.run, {}
    if grads:
        loss, gs = trainer.loss_and_grads(db)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(trainer.params, gs)]
        if run is None:
            out["grad_norm"] = float(global_norm(gs))
        else:
            gs = trainer.opt.reduce(gs)
            out["grad_norm"] = float(trainer.opt.norm(gs))
        out["grads"] = _h_whole_grads(torch, trainer, gs)
        del gs
    else:
        with torch.no_grad(), trainer._scope():
            loss = trainer._loss(db, train=True)
    out["loss"] = float(loss.detach() if run is None else run.sum_dp(loss.detach()))
    if logps:
        out["logps"] = _h_logps(torch, trainer, logp_args)
    return out


def _h_capture_first_step(torch, trainer, into):
    """Have the trainer's next optimizer step put its gradients (whole, on
    the host) into `into["grads"]`: the first step's own, not a second
    backward's."""
    opt = trainer.opt
    name = "step" if trainer.run is None else "_step_shards"
    real = getattr(opt, name)

    def hooked(grads):
        setattr(opt, name, real)
        into["grads"] = _h_whole_grads(torch, trainer, grads)
        return real(grads)
    setattr(opt, name, hooked)


def _h_compare(torch, mesh, one):
    """(h)'s readings against one device's first step: for each of loss,
    grad norm (relative differences), the gradients' cosine (in fp64) and
    the logps' largest difference, the noise floor (one device against
    itself), the mesh's and each planted fault's; the engine's
    teacher-forced cosine floor, and its first tokens where one device's
    top-2 gap exceeds twice the row's largest difference."""
    ref = one["first"]

    def read(x):
        out = {"loss": abs(x["loss"] - ref["loss"]) / abs(ref["loss"])}
        if "grads" in x:
            out["grad_norm"] = abs(x["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            out["grad_cos"] = _cos(torch, x["grads"], ref["grads"])
        if "logps" in x:
            out["logp"] = float((x["logps"] - ref["logps"]).abs().max())
        return out
    out = {"noise": read(one["again"]), "mesh": read(mesh["first"]),
           **{name: read(x) for name, x in mesh["faults"].items()},
           "n_grads": int(ref["grads"].numel()), "n_logps": int(ref["logps"].numel())}
    rows_m, rows_o = mesh["engine"]["rows"], one["engine"]["rows"]
    out["engine_cos"] = _tp_cos_floor(torch, rows_m, rows_o)
    top2 = rows_o[0].topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    clear = gap > 2 * (rows_m[0] - rows_o[0]).abs().amax(-1)
    agree = torch.as_tensor(rows_o[0].argmax(-1).numpy()
                            == np.asarray(mesh["engine"]["ids"])[:, 0])
    out["engine_first"] = bool(agree[clear].all())
    out["engine_first_clear"] = int(clear.sum())
    out["engine_first_equal"] = int(agree.sum())
    out["engine_rows"] = len(rows_m) * rows_m[0].shape[0]
    return out


def _bench_lora_sft():
    """(FusionConfig, SFTConfig) of (h) and (i): bf16 LoRA SFT at bench.py's
    shape, Qwen3-0.6B + NT-v2-500M at full width and depth, remat off."""
    from bioreason_tpu_torch.config import (DecoderConfig, EncoderConfig, FusionConfig,
                                            LoRAConfig, OptimConfig, SFTConfig)
    dec = dataclasses.replace(DecoderConfig.qwen3_0_6b(), remat=False)
    enc = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    cfg = FusionConfig(decoder=dec, encoder=enc, dna_pad_token_id=151938)
    sft = SFTConfig(batch_size=4, lora=LoRAConfig(r=32, alpha=64, dropout=0.0),
                    optim=OptimConfig(total_steps=100, warmup_ratio=0.0), seed=0)
    return cfg, sft


def _tp_vocab_sft(torch, dist, axis, mesh, seen, keep):
    """(24h) SFTTrainer(mesh) in bf16 with LoRA at bench.py's shape on the
    mesh (1, 1, 2), Qwen3-0.6B's 151,936-row table (tied head) and the
    DNA projection split over 'model', beside the one-device trainer on rank
    0 from the same seed (built after the mesh trainer is freed): each
    rank's table and projection pieces and their GiB, resident and peak
    GiB; at the first step's state the planted faults' readings (mesh) or
    the noise floor's (one device), and one `per_token_logps` pass of the
    batch's supervised tail; one greedy engine call of H_PROMPTS prompts
    and H_NEW new tokens on the ranks' shards, which one device then runs
    teacher-forced on the ranks' stream; TP_SFT_STEPS steps with their
    loss, grad norm, ms, launches and shapes, the first step's gradients
    kept. Rank 0 compares (`_h_compare`) and returns numbers only; it puts
    one device's first-step gradients (host) in `keep["grads"]` for (i)."""
    import types

    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.ops import fused_ce as CE
    from bioreason_tpu_torch.train.sft import SFTTrainer
    cfg, sft = _bench_lora_sft()
    batch = bench_batch(cfg)
    pb = bench_batch(cfg, b=H_PROMPTS, t_text=H_PROMPT_TEXT, l_dna=H_PROMPT_DNA)
    prompts = types.SimpleNamespace(**{k: pb[k] for k in (
        "input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")})
    tail = 128                                   # bench_batch's supervised positions
    logp_args = tuple(torch.as_tensor(batch[k], device="cuda") for k in (
        "input_ids", "attention_mask", "dna_input_ids", "dna_attention_mask")) + (tail,)
    eos = 151645
    res, forced = {}, [None]
    runs = [("mesh", mesh)] + ([("one", None)] if axis.index == 0 else [])
    for label, m in runs:
        t_run = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trainer = SFTTrainer(cfg, sft, mesh=m)
        table, proj = trainer.model.decoder.embed, trainer.model.dna_projection
        r = {"resident_gib": (torch.cuda.memory_allocated() - base) / 2**30,
             "table": tuple(table.weight.shape), "vocab_split": L.vocab_axis(table) is not None,
             "table_gib": table.weight.numel() * table.weight.element_size() / 2**30,
             "projection": tuple(proj.weight.shape),
             "projection_split": getattr(proj, "tp", None) is not None,
             "fallback": m is not None and trainer.run is None,
             "ms": [], "metrics": [], "launches": [], "shapes": []}
        db = trainer._device_batch(batch)
        t0 = time.perf_counter()
        if label == "mesh":
            r["faults"] = {}
            for name, (attr, fn, grads) in _vocab_faults(torch).items():
                sound = getattr(CE, attr)
                setattr(CE, attr, fn)
                try:
                    r["faults"][name] = _h_reading(torch, trainer, db, logp_args, grads,
                                                   logps=not grads)
                finally:
                    setattr(CE, attr, sound)
        else:                   # the noise floor: the first step's loss and gradients again
            r["again"] = _h_reading(torch, trainer, db, logp_args, True)
        r["first"] = {"logps": _h_logps(torch, trainer, logp_args)}
        r["readings_s"] = time.perf_counter() - t0
        engine = GenerationEngine(cfg, eos, device="cuda", run=trainer.run)
        call = _tp_engine_call(torch, engine, trainer.model, prompts, seen, 1, H_NEW,
                               forced=forced[0], greedy=True)
        if label == "mesh":
            forced[0] = torch.as_tensor(call["ids"], device="cuda")
        r["engine"] = {"ms": call["ms"], "launches": call["launches"],
                       "shapes": call["shapes"], "ids": call["ids"],
                       "rows": [x.cpu() for x in call["rows"]],
                       "cache_bytes": call["cache_bytes"]}
        del engine, call
        _h_capture_first_step(torch, trainer, r["first"])
        for _ in range(TP_SFT_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            for d in seen.values():
                d.clear()
            t0 = time.perf_counter()
            r["metrics"].append(trainer.train_step(batch))
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["launches"].append(counts())
            r["shapes"].append({k: dict(v) for k, v in seen.items()})
        r["first"].update(loss=r["metrics"][0]["loss"], grad_norm=r["metrics"][0]["grad_norm"])
        r["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        res[label] = r
        del trainer, db, table, proj
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_run
        if label == "mesh":
            dist.barrier()
    if "one" in res:
        res["readings"] = _h_compare(torch, res["mesh"], res["one"])
        keep["grads"] = res["one"]["first"]["grads"]
    for r in res.values():           # the host tensors stay on this rank
        for key in ("first", "again", "faults"):
            r.pop(key, None)
        if "engine" in r:
            r["engine"].pop("rows")
    g = res["mesh"]
    log(f"tp (h) rank {axis.index}: table {g['table']} ({g['table_gib']:.3f} GiB), projection "
        f"{g['projection']}; steps {[round(x, 1) for x in g['ms']]} ms; losses "
        f"{[round(x['loss'], 5) for x in g['metrics']]}; launches {g['launches']}; engine "
        f"{g['engine']['ms']:.1f} ms, flash_fwd {g['engine']['launches']}; resident "
        f"{g['resident_gib']:.3f} GiB, peak {g['peak_gib']:.3f} GiB; readings "
        f"{g['readings_s']:.1f} s; {g['seconds']:.1f} s in all"
        + (f" (one device {res['one']['seconds']:.1f} s)" if "one" in res else ""))
    return res


def _tp_fsdp_sft(torch, dist, axis, seen, one_grads):
    """(24i) (h)'s bf16 LoRA SFT at bench.py's shape on the mesh (1, 2, 1) of
    the same two processes: each rank stores half of every fsdp-sharded
    leaf (both towers' frozen bf16 layers, the tables, the projection, the
    adapters) and gathers them one layer, table or projection at a time
    (`partition.layer_gathered`; the backward gathers again what it reads).
    TP_SFT_STEPS steps: loss, grad norm, ms, launches and shapes; the most
    gathered bytes alive on the rank (`partition.GATHERED`) beside the
    plan's largest layer, largest parameter outside the layers and whole
    gather; resident and peak GiB. Rank 0 holds the first step's whole
    gradients to one device's (`one_grads`, (h)'s same configuration and
    seed) and returns their cosine."""
    from bioreason_tpu_torch.config import MeshConfig
    from bioreason_tpu_torch.parallel.mesh import make_mesh
    from bioreason_tpu_torch.parallel.partition import GATHERED
    from bioreason_tpu_torch.train.sft import SFTTrainer
    cfg, sft = _bench_lora_sft()
    batch = bench_batch(cfg)
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, model=1), device="cuda")
    t_run = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = SFTTrainer(cfg, sft, mesh=mesh)
    sizes = trainer.run.plan.gather_sizes(trainer.model)
    r = {"resident_gib": (torch.cuda.memory_allocated() - base) / 2**30,
         "fallback": trainer.run is None or trainer.run.topo.fsdp.size != 2,
         "layer_bytes": max(n for k, n in sizes.items() if ".layers." in k),
         "outside_bytes": max(n for k, n in sizes.items() if ".layers." not in k),
         "whole_bytes": sum(sizes.values()), "ms": [], "metrics": [], "launches": [],
         "shapes": []}
    first = {}
    _h_capture_first_step(torch, trainer, first)
    r["build_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()          # the steps' peak, apart from the build's
    GATHERED.reset()
    for _ in range(TP_SFT_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        for d in seen.values():
            d.clear()
        t0 = time.perf_counter()
        r["metrics"].append(trainer.train_step(batch))
        torch.cuda.synchronize()
        r["ms"].append((time.perf_counter() - t0) * 1e3)
        r["launches"].append(counts())
        r["shapes"].append({k: dict(v) for k, v in seen.items()})
    r["gathered_high"] = GATHERED.high
    r["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    if one_grads is not None:
        r["cos"] = _cos(torch, first["grads"], one_grads)
        r["n_grads"] = int(one_grads.numel())
    del trainer, first
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t_run
    log(f"tp (i) rank {axis.index}: bf16 LoRA SFT at fsdp 2, per-layer gathers: steps "
        f"{[round(x, 1) for x in r['ms']]} ms; losses "
        f"{[round(m['loss'], 5) for m in r['metrics']]}; launches {r['launches']}; gathered "
        f"high-water {r['gathered_high'] / 2**30:.3f} GiB (a layer {r['layer_bytes'] / 2**30:.4f}"
        f", outside the layers {r['outside_bytes'] / 2**30:.4f}, whole "
        f"{r['whole_bytes'] / 2**30:.3f}); resident {r['resident_gib']:.3f} GiB, peak "
        f"{r['peak_gib']:.3f} GiB in the steps, {r['build_peak_gib']:.3f} GiB in the build; "
        f"{r['seconds']:.1f} s")
    return r


def _i_gates(card, i0, i1, one, g_shapes):
    """(i)'s gates and logs against one device's run (`one`, (h)'s) and at
    (g)'s per-rank kernel shapes (`g_shapes`, its first step's)."""
    ms = lambda x: [round(v, 1) for v in x["ms"]]
    bound = 2 * i0["layer_bytes"] + i0["outside_bytes"]
    gib = lambda b: b / 2**30
    log(f"tp (i) [{card}] SFTTrainer(mesh 1,2,1) bf16 LoRA at bench.py's shape, every fsdp "
        f"leaf gathered per layer: gathered bytes high-water rank 0 "
        f"{gib(i0['gathered_high']):.4f} GiB, rank 1 {gib(i1['gathered_high']):.4f} GiB "
        f"(gate: two layers {gib(2 * i0['layer_bytes']):.4f} + the largest parameter outside "
        f"the layers {gib(i0['outside_bytes']):.4f} = {gib(bound):.4f} GiB; a whole gather, "
        f"reckoned from the plan, {gib(i0['whole_bytes']):.4f} GiB); resident / peak GiB in "
        f"the steps (in the build) rank 0 {i0['resident_gib']:.3f} / {i0['peak_gib']:.3f} "
        f"({i0['build_peak_gib']:.3f}), rank 1 {i1['resident_gib']:.3f} / "
        f"{i1['peak_gib']:.3f} ({i1['build_peak_gib']:.3f}), one device ((h)'s, its build "
        f"to its last step) {one['resident_gib']:.3f} / {one['peak_gib']:.3f}; step ms rank 0 {ms(i0)}, rank 1 {ms(i1)}, one device "
        f"{ms(one)}; losses {[x['loss'] for x in i0['metrics']]} vs one device "
        f"{[x['loss'] for x in one['metrics']]}; grad norms "
        f"{[x['grad_norm'] for x in i0['metrics']]} vs "
        f"{[x['grad_norm'] for x in one['metrics']]} (MESH_LOSS_RTOL {MESH_LOSS_RTOL}); the "
        f"first step's {i0['n_grads']} trainable gradients cosine {i0['cos']:.6f} (floor "
        f"{SP_COS}); launches a step rank 0 {i0['launches']}, rank 1 {i1['launches']}, one "
        f"device {one['launches']}; shapes {i0['shapes'][0]}")
    if i0["cos"] < SP_COS:
        fail(f"tp (i): the first step's gradients' cosine {i0['cos']} is under {SP_COS}")
    want_shapes = {k: set(v) for k, v in g_shapes.items()}
    for i in (i0, i1):
        if i["fallback"]:
            fail("tp (i): the mesh trainer ran without its fsdp axis")
        if not 0 < i["gathered_high"] <= bound:
            fail(f"tp (i): {i['gathered_high']} gathered bytes alive at once on a rank, not "
                 f"within two layers and the table's {bound}")
        for n, (got, want) in enumerate(zip(i["metrics"], one["metrics"])):
            for k in ("loss", "grad_norm"):
                if (not math.isfinite(got[k])
                        or not math.isclose(got[k], want[k], rel_tol=MESH_LOSS_RTOL)):
                    fail(f"tp (i): step {n}'s {k} {got[k]} against one device's {want[k]}")
        for got, want, shapes in zip(i["launches"], one["launches"], i["shapes"]):
            if got != want or not got["flash_fwd"] or not got["flash_bwd"]:
                fail(f"tp (i): a rank launched {got} in a step, one device {want}")
            if {k: set(v) for k, v in shapes.items()} != want_shapes:
                fail(f"tp (i): the kernels ran at {shapes}, not at (g)'s {g_shapes}")


def _tp_classifier(torch, dist, axis, mesh, seen):
    """(24e) ClassifierTrainer(mesh) at NT-v2-500M width in bf16, the encoder
    trained (remat off, as phase 13's (b)), on phase 13's batch [16, 512]:
    TP_CLS_STEPS steps, each step's launches and their shapes, its ms and
    loss; rank 0 runs the one-device trainer from the same seed beside it,
    its parameters set to the tensor-parallel model's whole ones before
    each step after the first, and holds the first step's encoder
    gradients (summed over the ranks, gathered) to its own."""
    from bioreason_tpu_torch.config import EncoderConfig, OptimConfig
    from bioreason_tpu_torch.train.classifier import ClassifierTrainer
    cfg = dataclasses.replace(EncoderConfig.nt_v2_500m(), remat=False)
    # train_dna_only's default learning rate: at phase 13's 1e-3 one step
    # drives this fixed batch's loss to ~2e-3, where the gate compares two
    # bf16 summation orders of a near-zero CE
    optim = OptimConfig(learning_rate=2e-5, total_steps=100, warmup_ratio=0.0)
    batch = classifier_batch()
    tp = ClassifierTrainer(cfg, CLS_CLASSES, optim=optim, train_just_classifier=False,
                           device="cuda", mesh=mesh)
    one = (ClassifierTrainer(cfg, CLS_CLASSES, optim=optim, train_just_classifier=False,
                             device="cuda") if axis.index == 0 else None)
    grads = {}
    real_tp = tp.opt._step_shards

    def tp_shards(shards):               # the first step's summed gradients
        if "tp" not in grads:
            grads["tp"] = {n: g.clone() for n, g in zip(tp.names, shards)
                           if n.startswith("encoder.")}
        return real_tp(shards)
    tp.opt._step_shards = tp_shards
    if one is not None:
        real_one = one.opt.step

        def one_step(gs):
            if "one" not in grads:
                grads["one"] = {n: g.float().clone() for n, g in zip(one.names, gs)
                                if n.startswith("encoder.")}
            return real_one(gs)
        one.opt.step = one_step
    res = {k: [] for k in ("loss", "ms", "launches", "shapes", "one_loss", "one_ms",
                           "one_launches")}
    for i in range(TP_CLS_STEPS):
        if i:                            # the one-device model on the same parameters
            with torch.no_grad():
                named = dict(zip(one.names, one.params)) if one is not None else {}
                for n, p in zip(tp.names, tp.params):
                    whole = tp.run.plan.unshard(n, p.detach())
                    if one is not None:
                        named[n].copy_(whole)
                    del whole
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        for d in seen.values():
            d.clear()
        t0 = time.perf_counter()
        m = tp.train_step(batch)
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(m["loss"])
        res["launches"].append(counts())
        res["shapes"].append({k: dict(v) for k, v in seen.items()})
        if i == 0:                       # gathered on both ranks, compared on rank 0
            whole = {n: tp.run.plan.unshard(n, g) for n, g in grads.pop("tp").items()}
        dist.barrier()
        if one is not None:
            reset_counts()
            t0 = time.perf_counter()
            m = one.train_step(batch)
            torch.cuda.synchronize()
            res["one_ms"].append((time.perf_counter() - t0) * 1e3)
            res["one_loss"].append(m["loss"])
            res["one_launches"].append(counts())
            if i == 0:                   # cosine and relative L2, leaf by leaf
                dot = sq_a = sq_b = sq_d = 0.0
                for n in sorted(whole):
                    a, b = whole[n].float().flatten(), grads["one"][n].flatten()
                    dot += float(a @ b)
                    sq_a += float(a @ a)
                    sq_b += float(b @ b)
                    sq_d += float((a - b) @ (a - b))
                res.update(cos=dot / math.sqrt(sq_a * sq_b), n_enc=len(whole),
                           rel_l2=math.sqrt(sq_d / sq_b))
                del grads["one"]
        if i == 0:
            del whole
        dist.barrier()
    log(f"tp (e) rank {axis.index}: classifier steps {[round(x, 1) for x in res['ms']]} ms "
        f"(one device {[round(x, 1) for x in res['one_ms']]}); losses {res['loss']} (one "
        f"device {res['one_loss']}); launches {res['launches']}; shapes {res['shapes']}")
    del tp, one
    return res


def _tp_world(rank, world, store, queue, one_step_ms):
    """One of the two processes of phase 24: rank `rank` on cuda:0."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        from bioreason_tpu_torch.config import MeshConfig
        from bioreason_tpu_torch.parallel.mesh import make_mesh, topology
        mesh = make_mesh(MeshConfig(data=1, fsdp=1, model=world), device="cuda")
        t0 = time.perf_counter()
        out = _tp_rank(torch, mesh, topology(mesh).model, one_step_ms)
        out["seconds"] = round(time.perf_counter() - t0, 1)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        import traceback
        queue.put((rank, None, traceback.format_exc()))


def tp_kernel_cases(torch, prompt_mask, hq, hkv, d):
    """(24d) flash_fwd and flash_bwd at a tensor-parallel rank's grouped
    prefill: [B_u, P, Hq/2, D] over Hkv/2, causal, the prompts' left pads."""
    bu, p = prompt_mask.shape
    name = f"tp_rank_prefill_P{p}_H{hq}_{hkv}"
    return ([kernel_case(torch, name, bu, p, p, hq, hkv, d, True, 0, prompt_mask, 51)],
            [bwd_case(torch, name, bu, p, p, hq, hkv, d, True, 0, prompt_mask, 52)])


def _tp_gates(torch, card, r0, r1, one_step_ms):
    """Phase 24's gates and logs on the two ranks' results (module note
    above the constants); returns the launches each part counted."""
    cfg = grpo_setup()[0]
    hq, hkv = cfg.decoder.num_heads // 2, cfg.decoder.num_kv_heads // 2
    eh = cfg.encoder.num_heads // 2                  # the NT tower's heads a rank
    per_call = ENCODER_LAYERS + DECODER_LAYERS
    # (a), (b)
    for part, label in (("a", f"{TP_PROMPTS} prompts, greedy, {TP_NEW} new tokens"),
                        ("b", f"grouped {GRPO_PROMPTS} prompts x G={GRPO_G}, greedy, "
                              f"{GRPO_NEW} new tokens"),
                        ("f", f"QLoRA's int8 rollout copy, int8 KV cache, grouped "
                              f"{GRPO_PROMPTS} prompts x G={GRPO_G}, greedy, {TP_NEW} "
                              f"new tokens")):
        x0, x1 = (r0[part], r1[part]) if part != "f" else (r0["f"]["engine"],
                                                            r1["f"]["engine"])
        firsts = [bool((x["first"] == x0["one_first"]).all()) for x in (x0, x1)]
        log(f"tp ({part}) [{card}] {label}: first tokens equal to one device's on rank 0, "
            f"rank 1 {firsts} (one device's smallest top-2 logit gap "
            f"{x0['one_top2_gap']:.4g}); "
            f"teacher-forced logits cosine floor {x0['cos']:.6f} (floor {CONT_STEP_COS}); "
            f"cache bytes rank 0 {x0['cache_bytes']}, rank 1 {x1['cache_bytes']}, one device "
            f"{x0['one_cache_bytes']}; engine call ms rank 0 {x0['ms']:.1f}, rank 1 "
            f"{x1['ms']:.1f}, one device {x0['one_ms']:.1f}; flash_fwd per call rank 0 "
            f"{x0['launches']}, rank 1 {x1['launches']}, one device {x0['one_launches']}")
        if not all(firsts):
            fail(f"tp ({part}): the first tokens differ from one device's")
        if x0["cos"] < CONT_STEP_COS:
            fail(f"tp ({part}): teacher-forced logits cosine {x0['cos']} under {CONT_STEP_COS}")
        for x in (x0, x1):
            if 2 * x["cache_bytes"] != x0["one_cache_bytes"]:
                fail(f"tp ({part}): a rank's cache of {x['cache_bytes']} B is not half of one "
                     f"device's {x0['one_cache_bytes']} B")
            if x["launches"] != per_call:
                fail(f"tp ({part}): {x['launches']} flash_fwd in an engine call, not {per_call}")
            dec = {k: n for k, n in x["shapes"].items() if k[5] == cfg.decoder.head_dim}
            if sum(dec.values()) != DECODER_LAYERS or any(k[3:5] != (hq, hkv) for k in dec):
                fail(f"tp ({part}): the decoder's flash_fwd ran at {dec}, not "
                     f"{DECODER_LAYERS} launches of {hq}/{hkv} heads")
            enc = {k: n for k, n in x["shapes"].items() if k[5] == cfg.encoder.head_dim}
            if sum(enc.values()) != ENCODER_LAYERS or any(k[3:5] != (eh, eh) for k in enc):
                fail(f"tp ({part}): the encoder's flash_fwd ran at {enc}, not "
                     f"{ENCODER_LAYERS} launches of {eh} heads")
    # (c), (f)
    per_step = {"flash_fwd": 3 * ENCODER_LAYERS + 4 * DECODER_LAYERS,
                "flash_bwd": DECODER_LAYERS}
    for part, label in (("c", "GRPOTrainer(mesh 1,1,2)"),
                        ("f", "GRPOTrainer(mesh 1,1,2, frozen_dtype='int8', rollout_int8, "
                              "rollout_kv_int8)")):
        c0, c1 = r0[part], r1[part]
        if c0["completions"] != c1["completions"]:
            fail(f"tp ({part}): the ranks' sampled rollouts differ")
        want = {k: TP_GRPO_STEPS * per_step.get(k, 0) for k in c0["launches"]}
        loss_tol = MESH_LOSS_RTOL * max(abs(c0["ref_loss"]), c0["loss_scale"])
        one_ms = c0["one_step_ms"] if c0.get("one_step_ms") is not None else float("nan")
        log(f"tp ({part}) [{card}] {label}, {GRPO_PROMPTS} prompts x G={GRPO_G}, "
            f"{GRPO_NEW} new tokens: step ms rank 0 {c0['step_ms']:.1f}, rank 1 "
            f"{c1['step_ms']:.1f}, one device {one_ms:.1f} "
            f"({'phase 8' if part == 'c' and one_step_ms is not None else 'rank 0'}); peak "
            f"GiB a rank {c0['peak_gib']:.3f}, {c1['peak_gib']:.3f}; per step " + "; ".join(
                f"loss {m['loss']:.5g} kl {m['kl']:.4g} reward {m['reward']:.3g}"
                for m in c0["hist"]) + f"; launches rank 0 {c0['launches']}, rank 1 "
            f"{c1['launches']} (expected {want}); {c0['moved']} of {c0['n_b']} LoRA B leaves "
            f"moved; the ranks' {sum(map(len, c0['completions']))} sampled completions "
            f"equal; one update on the last buffer: loss {c0['update_loss']:.6g} vs one "
            f"device {c0['ref_loss']:.6g} (held within {loss_tol:.3g}: MESH_LOSS_RTOL of the "
            f"larger of |loss| and the mean |advantage| {c0['loss_scale']:.4g}), the "
            f"{c0['n_lora']} LoRA gradients cosine {c0['cos']:.6f}, relative L2 "
            f"{c0['rel_l2']:.4g}")
        for c in (c0, c1):
            if any(not math.isfinite(m[k]) for m in c["hist"]
                   for k in ("loss", "kl", "reward")):
                fail(f"tp ({part}): non-finite GRPO loss, kl or reward: {c['hist']}")
            if c["launches"] != want:
                fail(f"tp ({part}): a rank launched {c['launches']} in {TP_GRPO_STEPS} steps, "
                     f"expected {want}")
            dec_bwd = list(c["shapes"]["flash_bwd"])
            if not dec_bwd or any(k[3:5] != (hq, hkv) for k in dec_bwd):
                fail(f"tp ({part}): flash_bwd ran at {dec_bwd}, not at {hq}/{hkv} heads")
            dec_fwd = {k: n for k, n in c["shapes"]["flash_fwd"].items()
                       if k[5] == cfg.decoder.head_dim}
            if any(k[3:5] != (hq, hkv) for k in dec_fwd):
                fail(f"tp ({part}): the decoder's flash_fwd ran at {dec_fwd}, not at "
                     f"{hq}/{hkv} heads")
            enc_fwd = {k: n for k, n in c["shapes"]["flash_fwd"].items()
                       if k[5] == cfg.encoder.head_dim}
            if (sum(enc_fwd.values()) != TP_GRPO_STEPS * 3 * ENCODER_LAYERS
                    or any(k[3:5] != (eh, eh) for k in enc_fwd)):
                fail(f"tp ({part}): the encoder's flash_fwd ran at {enc_fwd}, not "
                     f"{TP_GRPO_STEPS * 3 * ENCODER_LAYERS} launches of {eh} heads")
        if c0["moved"] != c0["n_b"]:
            fail(f"tp ({part}): only {c0['moved']} of {c0['n_b']} LoRA B leaves moved")
        if abs(c0["update_loss"] - c0["ref_loss"]) > loss_tol or c0["cos"] < SP_COS:
            fail(f"tp ({part}): the tensor-parallel update disagrees with one device: "
                 f"{ {k: v for k, v in c0.items() if k not in ('shapes', 'completions')} }")
    # (f): the int8 storage replicated, as JAX places it
    f0, f1 = r0["f"], r1["f"]
    log(f"tp (f) [{card}] int8 bytes a rank: the training model {f0['int8_bytes']}, "
        f"{f1['int8_bytes']} (one device {f0['one_int8_bytes']}); the rollout copy "
        f"{f0['rollout_int8_bytes']}, {f1['rollout_int8_bytes']} (one device "
        f"{f0['one_rollout_int8_bytes']}); resident GiB a rank {f0['resident_gib']:.3f} "
        f"(with rank 0's one-device trainers), {f1['resident_gib']:.3f}")
    for f in (f0, f1):
        if (f["int8_bytes"] != f0["one_int8_bytes"] or not f["int8_bytes"]
                or f["rollout_int8_bytes"] != f0["one_rollout_int8_bytes"]):
            fail(f"tp (f): a rank holds {f['int8_bytes']} / {f['rollout_int8_bytes']} int8 "
                 f"bytes, one device {f0['one_int8_bytes']} / {f0['one_rollout_int8_bytes']}")
    # (g)
    g0, g1 = r0["g"], r1["g"]
    one = g0["one"]
    log(f"tp (g) [{card}] SFTTrainer(mesh 1,2,1, frozen_dtype='int8') at bench.py's shape: "
        f"step ms rank 0 {[round(x, 1) for x in g0['mesh']['ms']]}, rank 1 "
        f"{[round(x, 1) for x in g1['mesh']['ms']]}, one device "
        f"{[round(x, 1) for x in one['ms']]}; losses {[m['loss'] for m in g0['mesh']['metrics']]}"
        f" vs one device {[m['loss'] for m in one['metrics']]}, grad norms "
        f"{[m['grad_norm'] for m in g0['mesh']['metrics']]} vs "
        f"{[m['grad_norm'] for m in one['metrics']]} (MESH_LOSS_RTOL {MESH_LOSS_RTOL}); "
        f"launches a step rank 0 {g0['mesh']['launches']}, rank 1 {g1['mesh']['launches']}, "
        f"one device {one['launches']}; resident / peak GiB rank 0 "
        f"{g0['mesh']['resident_gib']:.3f} / {g0['mesh']['peak_gib']:.3f}, rank 1 "
        f"{g1['mesh']['resident_gib']:.3f} / {g1['mesh']['peak_gib']:.3f}, one device "
        f"{one['resident_gib']:.3f} / {one['peak_gib']:.3f}; int8 bytes a rank "
        f"{g0['mesh']['int8_bytes']}, {g1['mesh']['int8_bytes']} (one device "
        f"{one['int8_bytes']})")
    for g in (g0["mesh"], g1["mesh"]):
        if g["fallback"]:
            fail("tp (g): the mesh trainer ran without its mesh")
        for i, (got, want) in enumerate(zip(g["metrics"], one["metrics"])):
            for k in ("loss", "grad_norm"):
                if (not math.isfinite(got[k])
                        or not math.isclose(got[k], want[k], rel_tol=MESH_LOSS_RTOL)):
                    fail(f"tp (g): step {i}'s {k} {got[k]} against one device's {want[k]}")
        for got, want in zip(g["launches"], one["launches"]):
            if got != want or not got["flash_fwd"] or not got["flash_bwd"]:
                fail(f"tp (g): a rank launched {got} in a step, one device {want}")
        if g["int8_bytes"] != one["int8_bytes"] or not g["int8_bytes"]:
            fail(f"tp (g): a rank holds {g['int8_bytes']} int8 bytes, one device "
                 f"{one['int8_bytes']}")
    # (e)
    e0, e1 = r0["e"], r1["e"]
    shape = (CLS_B, CLS_L, CLS_L, eh, eh, cfg.encoder.head_dim)
    log(f"tp (e) [{card}] ClassifierTrainer(mesh 1,1,2) at NT-v2-500M, bf16, the encoder "
        f"trained, remat off, [{CLS_B}, {CLS_L}] pairs: step ms rank 0 "
        f"{[round(x, 1) for x in e0['ms']]}, rank 1 {[round(x, 1) for x in e1['ms']]}, one "
        f"device {[round(x, 1) for x in e0['one_ms']]}; losses {e0['loss']} vs one device "
        f"{e0['one_loss']} (MESH_LOSS_RTOL {MESH_LOSS_RTOL}); the {e0['n_enc']} encoder "
        f"gradients of the first step cosine {e0['cos']:.6f} (floor {SP_COS}), relative L2 "
        f"{e0['rel_l2']:.4g}; launches a step rank 0 {e0['launches']}, rank 1 "
        f"{e1['launches']}, one device {e0['one_launches']}; shapes {e0['shapes'][0]}")
    for i, (got, want) in enumerate(zip(e0["loss"], e0["one_loss"])):
        if not math.isfinite(got) or abs(got - want) > MESH_LOSS_RTOL * abs(want):
            fail(f"tp (e): step {i}'s loss {got} against one device's {want}")
    if e0["cos"] < SP_COS:
        fail(f"tp (e): the encoder gradients' cosine {e0['cos']} is under {SP_COS}")
    for e in (e0, e1):
        for got, want, shapes in zip(e["launches"], e0["one_launches"], e["shapes"]):
            if got != want or not got["flash_fwd"] or not got["flash_bwd"]:
                fail(f"tp (e): a rank launched {got} in a step, one device {want}")
            if any(set(shapes[k]) != {shape} for k in ("flash_fwd", "flash_bwd")):
                fail(f"tp (e): the classifier's kernels ran at {shapes}, not at {shape}")
    _h_gates(card, r0["h"], r1["h"], hq, hkv, eh, cfg)
    _i_gates(card, r0["i"], r1["i"], r0["h"]["one"], g0["mesh"]["shapes"][0])
    cls = lambda k: [sum(st[k] for st in e["launches"]) for e in (e0, e1)]
    grpo = lambda part, k: [r[part]["launches"][k] for r in (r0, r1)]
    sft = lambda k: [sum(st[k] for st in g["mesh"]["launches"]) for g in (g0, g1)]
    vocab = lambda k: [sum(st[k] for st in r["h"]["mesh"]["launches"]) for r in (r0, r1)]
    fsdp_lora = lambda k: [sum(st[k] for st in r["i"]["launches"]) for r in (r0, r1)]
    launches = {"fwd": {"engine_per_call": [r0["a"]["launches"], r1["a"]["launches"]],
                        "grouped_per_call": [r0["b"]["launches"], r1["b"]["launches"]],
                        "grpo_steps": grpo("c", "flash_fwd"),
                        "classifier_steps": cls("flash_fwd"),
                        "qlora_grouped_per_call": [f0["engine"]["launches"],
                                                   f1["engine"]["launches"]],
                        "qlora_grpo_steps": grpo("f", "flash_fwd"),
                        "qlora_sft_fsdp_steps": sft("flash_fwd"),
                        "vocab_sft_steps": vocab("flash_fwd"),
                        "vocab_engine_per_call": [r["h"]["mesh"]["engine"]["launches"]
                                                  for r in (r0, r1)],
                        "lora_sft_fsdp_steps": fsdp_lora("flash_fwd")},
                "bwd": {"grpo_steps": grpo("c", "flash_bwd"),
                        "classifier_steps": cls("flash_bwd"),
                        "qlora_grpo_steps": grpo("f", "flash_bwd"),
                        "qlora_sft_fsdp_steps": sft("flash_bwd"),
                        "vocab_sft_steps": vocab("flash_bwd"),
                        "lora_sft_fsdp_steps": fsdp_lora("flash_bwd")}}
    return launches


def _h_gates(card, h0, h1, hq, hkv, eh, gcfg):
    """(h)'s gates and logs: the ranks' pieces, the steps against one device,
    the readings against their noise floor and planted faults (`H_GATES`),
    the engine call."""
    one, rd = h0["one"], h0["readings"]
    v, hid, d = 151936, gcfg.decoder.hidden_size, gcfg.encoder.hidden_size
    ms = lambda r: [round(x, 1) for x in r["ms"]]
    log(f"tp (h) [{card}] SFTTrainer(mesh 1,1,2) bf16 LoRA at bench.py's shape, Qwen3-0.6B's "
        f"table split: table a rank {h0['mesh']['table']} {h0['mesh']['table_gib']:.3f} GiB, "
        f"{h1['mesh']['table']} {h1['mesh']['table_gib']:.3f} GiB (one device {one['table']} "
        f"{one['table_gib']:.3f} GiB); projection a rank {h0['mesh']['projection']}, "
        f"{h1['mesh']['projection']} (one device {one['projection']}); resident / peak GiB "
        f"rank 0 {h0['mesh']['resident_gib']:.3f} / {h0['mesh']['peak_gib']:.3f}, rank 1 "
        f"{h1['mesh']['resident_gib']:.3f} / {h1['mesh']['peak_gib']:.3f}, one device "
        f"{one['resident_gib']:.3f} / {one['peak_gib']:.3f}; step ms rank 0 "
        f"{ms(h0['mesh'])}, rank 1 {ms(h1['mesh'])}, one device {ms(one)}; losses "
        f"{[x['loss'] for x in h0['mesh']['metrics']]} vs one device "
        f"{[x['loss'] for x in one['metrics']]}; grad norms "
        f"{[x['grad_norm'] for x in h0['mesh']['metrics']]} vs "
        f"{[x['grad_norm'] for x in one['metrics']]}; launches a step rank 0 "
        f"{h0['mesh']['launches']}, rank 1 {h1['mesh']['launches']}, one device "
        f"{one['launches']}; shapes {h0['mesh']['shapes'][0]}")
    for key, (fault, gate) in H_GATES.items():
        faults = ", ".join(f"{n} {rd[n][key]:.4g}" for n in _vocab_faults(None)
                           if key in rd[n])
        log(f"tp (h) [{card}] {key}: the mesh {rd['mesh'][key]:.4g}; one device's same step "
            f"once more (noise floor) {rd['noise'][key]:.4g}; planted faults "
            f"{faults}; gate {gate} (against {fault}; {rd['n_grads']} gradients, "
            f"{rd['n_logps']} logps)")
    log(f"tp (h) [{card}] engine: {H_PROMPTS} prompts, greedy, {H_NEW} new tokens on the "
        f"split table; one device teacher-forced on the ranks' stream: first tokens equal "
        f"{rd['engine_first_equal']} of {H_PROMPTS}, all {rd['engine_first_clear']} whose "
        f"top-2 gap exceeds twice the row's largest difference {rd['engine_first']}, "
        f"logits cosine floor {rd['engine_cos']:.6f} over "
        f"{rd['engine_rows']} rows (floor {CONT_STEP_COS}); call ms rank 0 "
        f"{h0['mesh']['engine']['ms']:.1f}, rank 1 {h1['mesh']['engine']['ms']:.1f}, one "
        f"device {one['engine']['ms']:.1f}; cache bytes {h0['mesh']['engine']['cache_bytes']}, "
        f"one device {one['engine']['cache_bytes']}; flash_fwd a call "
        f"{h0['mesh']['engine']['launches']}, {h1['mesh']['engine']['launches']}")
    if one["vocab_split"] or one["table"] != (v, hid) or one["projection"] != (hid, d):
        fail(f"tp (h): the one-device model holds {one['table']} / {one['projection']}")
    for h in (h0["mesh"], h1["mesh"]):
        if h["fallback"] or not h["vocab_split"] or not h["projection_split"]:
            fail("tp (h): a rank ran without its mesh or with a replicated table or projection")
        if h["table"] != (v // 2, hid) or h["projection"] != (hid // 2, d):
            fail(f"tp (h): a rank holds the table {h['table']} and the projection "
                 f"{h['projection']}, not {(v // 2, hid)} and {(hid // 2, d)}")
        for i, (got, want) in enumerate(zip(h["metrics"], one["metrics"])):
            for k, tol in (("loss", H_LOSS_RTOL), ("grad_norm", H_NORM_RTOL)):
                if not math.isfinite(got[k]) or abs(got[k] - want[k]) > tol * abs(want[k]):
                    fail(f"tp (h): step {i}'s {k} {got[k]} against one device's {want[k]}")
        for got, want, shapes in zip(h["launches"], one["launches"], h["shapes"]):
            if got != want or not got["flash_fwd"] or not got["flash_bwd"]:
                fail(f"tp (h): a rank launched {got} in a step, one device {want}")
            for k in ("flash_fwd", "flash_bwd"):
                heads = {key[3:5] for key in shapes[k]
                         if key[5] == gcfg.decoder.head_dim}
                if heads != {(hq, hkv)}:
                    fail(f"tp (h): the decoder's {k} ran at {shapes[k]}, not {hq}/{hkv} heads")
            if {key[3:5] for key in shapes["flash_fwd"]
                    if key[5] == gcfg.encoder.head_dim} != {(eh, eh)}:
                fail(f"tp (h): the encoder ran at {shapes['flash_fwd']}, not {eh} heads")
        e = h["engine"]
        if (e["launches"] != ENCODER_LAYERS + DECODER_LAYERS
                or 2 * e["cache_bytes"] != one["engine"]["cache_bytes"]):
            fail(f"tp (h): the engine call launched {e['launches']} flash_fwd with a cache of "
                 f"{e['cache_bytes']} B (one device {one['engine']['cache_bytes']} B)")
    if not rd["engine_first"] or rd["engine_cos"] < CONT_STEP_COS:
        fail(f"tp (h): the engine's first tokens or logits disagree with one device's: "
             f"{rd['engine_first']}, cosine {rd['engine_cos']}")
    for key, (fault, gate) in H_GATES.items():
        within = ((lambda x: x >= gate) if key == "grad_cos" else (lambda x: x <= gate))
        if not within(rd["noise"][key]) or within(rd[fault][key]):
            fail(f"tp (h): the {key} gate {gate} does not part the noise floor "
                 f"{rd['noise'][key]} from the planted fault {fault}'s "
                 f"{rd[fault][key]}")
        if not within(rd["mesh"][key]):
            fail(f"tp (h): the mesh's {key} {rd['mesh'][key]} is past its gate {gate}")


def phase_tp(torch, card, one_step_ms=None):
    """(24) Generation, GRPO and the classifier under the mesh's 'model'
    axis: two ranks in two processes on the card over gloo, mesh (1, 1, 2),
    Qwen3-0.6B + NT-v2-500M in bf16 from seed 0 at phase 8's GRPO
    configuration, then the classifier at phase 13's shape; each check
    against rank 0's one-device model (module note above), the GRPO step
    time against `one_step_ms` (phase 8's; else rank 0 times its own)."""
    import multiprocessing as mp
    t_phase = time.perf_counter()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = _store("tp")
    procs = [ctx.Process(target=_tp_world, args=(r, 2, store, queue, one_step_ms))
             for r in range(2)]
    for p in procs:
        p.start()
    results = [None, None]
    try:
        while None in results:
            try:
                rank, out, err = queue.get(timeout=5)
            except Exception:                    # queue.Empty: is every rank alive?
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() - t_phase > TP_HANG_S:
                    fail(f"the tensor-parallel world died or hung (exit codes "
                         f"{[p.exitcode for p in procs]}; its stderr is above)")
                continue
            if err is not None:
                fail(f"rank {rank} of the tensor-parallel world raised:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    r0, r1 = results
    launches = _tp_gates(torch, card, r0, r1, one_step_ms)
    cfg = grpo_setup()[0]
    hq, hkv = cfg.decoder.num_heads // 2, cfg.decoder.num_kv_heads // 2
    eh = cfg.encoder.num_heads // 2
    g0 = r0["g"]
    # (d)
    pmask = torch.as_tensor(r0["b"]["prompt_mask"], dtype=torch.int32, device="cuda")
    rows, bwd_rows = tp_kernel_cases(torch, pmask, hq, hkv, cfg.decoder.head_dim)
    ones = torch.ones((CLS_B, CLS_L), dtype=torch.int32, device="cuda")
    rows.append(kernel_case(torch, f"tp_rank_classifier_encoder_B{CLS_B}_T{CLS_L}_H{eh}",
                            CLS_B, CLS_L, CLS_L, eh, eh, cfg.encoder.head_dim, False, None,
                            ones, 241))
    bwd_rows.append(bwd_case(torch, f"tp_rank_classifier_finetune_B{CLS_B}_T{CLS_L}_H{eh}",
                             CLS_B, CLS_L, CLS_L, eh, eh, cfg.encoder.head_dim, False, 0,
                             ones, 242))
    # (g)'s per-rank shapes: 2 of bench.py's 4 rows a rank (fsdp), all valid
    for key in sorted(set(g0["mesh"]["shapes"][0]["flash_fwd"])
                      | set(g0["mesh"]["shapes"][0]["flash_bwd"])):
        b, tq, tk, h, hk, d = key
        causal = d == cfg.decoder.head_dim
        mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
        name = f"tp_fsdp_qlora_sft_B{b}_T{tq}_H{h}_{hk}_D{d}"
        if key in g0["mesh"]["shapes"][0]["flash_fwd"]:
            rows.append(kernel_case(torch, name, b, tq, tk, h, hk, d, causal,
                                    0 if causal else None, mask, 243))
        if key in g0["mesh"]["shapes"][0]["flash_bwd"]:
            bwd_rows.append(bwd_case(torch, name, b, tq, tk, h, hk, d, causal, 0, mask, 244))
    # (h)'s per-rank shapes: bench.py's 4 rows, Hq/2, Hkv/2 (the encoder's
    # at its frozen forward, 8 heads)
    h_shapes = r0["h"]["mesh"]["shapes"][0]
    for key in sorted(set(h_shapes["flash_fwd"]) | set(h_shapes["flash_bwd"])):
        b, tq, tk, h, hk, d = key
        causal = d == cfg.decoder.head_dim
        mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
        name = f"tp_vocab_sft_B{b}_T{tq}_H{h}_{hk}_D{d}"
        if key in h_shapes["flash_fwd"]:
            rows.append(kernel_case(torch, name, b, tq, tk, h, hk, d, causal,
                                    0 if causal else None, mask, 245))
        if key in h_shapes["flash_bwd"]:
            bwd_rows.append(bwd_case(torch, name, b, tq, tk, h, hk, d, causal, 0, mask, 246))
    log(f"tp: phase done in {time.perf_counter() - t_phase:.1f} s (rank seconds "
        f"{r0['seconds']}, {r1['seconds']}; by part, rank 0 {r0['parts']}, rank 1 "
        f"{r1['parts']})")
    return {"ranks": results, "launches": launches}, rows, bwd_rows


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA card")
    if not os.path.isdir(os.path.join(REPO, "bioreason_tpu_torch")):
        fail(f"the port's package bioreason_tpu_torch is not beside {__file__}")
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    seconds, last = {}, [t_start]

    def mark(name):
        """The script's clock since the previous mark, under `name`."""
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now
    max_new = 64
    card = phase_device(torch)
    built = phase_build()
    mark("device, build")
    rows, bwd_rows, band_rows = phase_kernels(torch, max_new)
    f32_rows = f32_kernel_cases(torch, max_new)
    mark("kernels")
    launches, server, items = phase_serve(torch, card, max_new)
    phase_profile(torch, card, server, items, max_new=8)
    del server
    torch.cuda.empty_cache()
    mark("serve, profile")
    build_dir = os.path.join(REPO, "bioreason_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_sft_", dir=build_dir)
    try:
        train = phase_train(torch, card, ckpt)
        torch.cuda.empty_cache()
        mark("train")
        long = phase_train_long(torch, card)
        torch.cuda.empty_cache()
        mark("train-long")
        grpo, grpo_rows, grpo_bwd_rows, grpo_step_ms = phase_grpo(
            torch, card, os.path.join(ckpt, "sft_final"))
        mark("grpo")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    golden_err = phase_evo2_goldens(torch)
    evo2_serve, evo2_batch = phase_evo2_serve(torch, card, max_new)
    torch.cuda.empty_cache()
    evo2_rows, evo2_bwd_rows = evo2_kernel_cases(torch, evo2_batch)
    mark("evo2")
    evo2_train = phase_evo2_train(torch, card)
    torch.cuda.empty_cache()
    mark("evo2-train")
    pretrained = phase_pretrained(torch, card, max_new)
    torch.cuda.empty_cache()
    mark("pretrained")
    continuous, cont_rows = phase_continuous(torch, card)
    mark("continuous")
    classifier, cls_rows, cls_bwd_rows = phase_classifier(torch, card)
    torch.cuda.empty_cache()
    mark("classifier")
    int8, int8_rows = phase_int8(torch, card)
    torch.cuda.empty_cache()
    mark("int8")
    qlora, qlora_rows, qlora_bwd_rows = phase_qlora(torch, card)
    torch.cuda.empty_cache()
    mark("qlora")
    reh, reh_rows, reh_bwd_rows = phase_rehearsal(torch, card)
    mark("rehearsal")
    moe, moe_rows = phase_moe(torch, card)
    mark("moe")
    moe_train = phase_moe_train(torch, card)
    mark("moe_train")
    fp32 = phase_fp32_api(torch, card)
    mark("fp32_api")
    torch.cuda.empty_cache()
    two = phase_two_ranks(torch, card)
    mark("sp_pp")
    sp_rows, sp_band_rows = sp_kernel_cases(torch)
    mark("sp_kernels")
    mesh = phase_mesh(torch, card)
    torch.cuda.empty_cache()
    mark("mesh")
    learns = phase_grpo_learns(torch, card)
    mark("grpo_learns")
    torch.cuda.empty_cache()
    tp, tp_rows, tp_bwd_rows = phase_tp(torch, card, grpo_step_ms)
    mark("tp")
    log(f"chip_smoke: seconds of the script's clock by phase {seconds}")
    log(f"chip_smoke: all phases done in {time.perf_counter() - t_start:.1f} s")

    rows += (grpo_rows + evo2_rows + cont_rows + cls_rows + int8_rows + qlora_rows + reh_rows
             + moe_rows + [moe_train["fwd_row"]] + sp_rows + tp_rows)
    band_rows += sp_band_rows
    r0, r1 = two["ranks"]
    rank_launches = lambda name: {
        "sp_long": [r["sp_long"]["launches"][name] for r in (r0, r1)],
        "sp_encoder": [r["sp_encoder"]["launches"][name] for r in (r0, r1)],
        "sp_evo2": [r["sp_evo2"]["launches"][name] for r in (r0, r1)],
        "pp_stages": [r["pp"]["launches"][name] for r in (r0, r1)]}
    bwd_rows += (grpo_bwd_rows + evo2_bwd_rows + cls_bwd_rows + qlora_bwd_rows + reh_bwd_rows
                 + [moe_train["bwd_row"]] + tp_bwd_rows)
    moe_train_launches = {k: {kk: v for kk, v in moe_train[k]["launches"].items() if v}
                          for k in ("sft", "grpo", "qlora_sft", "qlora_grpo")}
    qlora_launches = {"sft_int8": qlora["sft"]["int8"]["launches"],
                      "sft_bfloat16": qlora["sft"]["bfloat16"]["launches"],
                      "grpo_int8": qlora["grpo"]["launches"],
                      "rollout": {k: v["launches"] for k, v in qlora["rollout"].items()}}
    evo2_launches = {"serve": evo2_serve["flash_fwd"],
                     **{mode: evo2_train[mode]["launches"]
                        for mode in ("frozen", "finetune", "trainer")}}
    # the served prefill: the kernel's largest call
    served = next(r for r in rows if r["shape"].startswith("prefill_served"))
    fwd_entry = {"name": "flash_fwd", "route": "cuda",
                 "source": "bioreason_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "bioreason_tpu/ops/flash_attention.py:60",
                 "also_replaces": ["bioreason_tpu/ops/flash_attention.py:239"],
                 "launches": launches, "train_launches": train["fwd_launches"],
                 "long_launches": long["flash_fwd"], "grpo_launches": grpo["flash_fwd"],
                 "evo2_launches": {k: v if isinstance(v, int) else v["flash_fwd"]
                                   for k, v in evo2_launches.items()},
                 "pretrained_launches": {"sft": pretrained["sft"]["launches"]["flash_fwd"],
                                         "reason": pretrained["grpo"]["launches"]["flash_fwd"],
                                         "serve": pretrained["serve"]["launches"]},
                 "continuous_launches": {
                     "bench": continuous["bench"]["launches"],
                     "bench_prefill_chunks": continuous["bench"]["prefill_calls"] + 1,
                     "per_prefill_chunk": ENCODER_LAYERS + DECODER_LAYERS,
                     "per_decode_window": 0},
                 "classifier_launches": {
                     "frozen_bench": classifier["frozen"]["launches"],
                     "frozen_bench_steps": classifier["frozen"]["steps"],
                     "finetune": classifier["finetune"]["launches"]["flash_fwd"],
                     "finetune_remat_step": classifier["finetune"]["remat_launches"]["flash_fwd"],
                     "cli": classifier["cli"]["launches"]["flash_fwd"]},
                 "int8_launches": {
                     "serve_all_flags": int8["serve"]["launches"],
                     "serve_engine_calls": int8["serve"]["calls"],
                     "bench_int8": int8["bench"]["int8"]["launches"],
                     "bench_all_flags": int8["bench"]["all"]["launches"]},
                 "qlora_launches": {
                     "sft_int8": qlora_launches["sft_int8"]["flash_fwd"],
                     "sft_bfloat16": qlora_launches["sft_bfloat16"]["flash_fwd"],
                     "grpo_int8": qlora_launches["grpo_int8"]["flash_fwd"],
                     "rollout": qlora_launches["rollout"]},
                 "rehearsal_launches": {"total": reh["a"]["launches"].get("flash_fwd", 0),
                                        "calls": reh["a"]["calls"],
                                        "per_call": {k: sorted({d.get("flash_fwd", 0) for d in v})
                                                     for k, v in reh["a"]["per_call"].items()}},
                 "moe_train_launches": {k: v.get("flash_fwd", 0)
                                        for k, v in moe_train_launches.items()},
                 "moe_launches": {"serve": moe["serve"]["launches"],
                                  "serve_engine_calls": moe["serve"]["calls"],
                                  "per_engine_call": moe["serve"]["per_engine_call"],
                                  "prefill_alone": moe["serve"]["prefill_alone"],
                                  "per_decode_step": moe["serve"]["per_decode_step"],
                                  "bench": moe["continuous"]["launches"]},
                 "two_rank_launches": rank_launches("flash_fwd"),
                 "mesh_launches": mesh["mesh"]["launches"]["flash_fwd"],
                 "grpo_learns_launches": learns["launches"]["flash_fwd"],
                 "tp_launches": tp["launches"]["fwd"],
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "ms": served["ms"], "plain_ms": served["plain_ms"],
                 "bound_ms": served["bound_ms"], "bound_by": served["bound_by"],
                 "library_ms": served["library_ms"], "at_shape": served["shape"],
                 "build": {fn: r for fn, r in built.items() if "flash_fwd_kernel" in fn},
                 "shapes": rows}
    sft = bwd_rows[0]                  # sft_T768: bench.py's training shape
    bwd_entry = {"name": "flash_bwd", "route": "cuda",
                 "source": "bioreason_tpu_torch/csrc/flash_bwd.cu",
                 "replaces": "bioreason_tpu/ops/flash_attention.py:118",
                 "also_replaces": ["bioreason_tpu/ops/flash_attention.py:160",
                                   "bioreason_tpu/ops/flash_attention.py:271"],
                 "launches": train["bwd_launches"], "long_launches": long["flash_bwd"],
                 "grpo_launches": grpo["flash_bwd"],
                 "evo2_launches": {k: v["flash_bwd"] for k, v in evo2_launches.items()
                                   if not isinstance(v, int)},
                 "pretrained_launches": {"sft": pretrained["sft"]["launches"]["flash_bwd"],
                                         "reason": pretrained["grpo"]["launches"]["flash_bwd"]},
                 "classifier_launches": {
                     "finetune": classifier["finetune"]["launches"]["flash_bwd"],
                     "finetune_remat_step": classifier["finetune"]["remat_launches"]["flash_bwd"]},
                 "qlora_launches": {
                     "sft_int8": qlora_launches["sft_int8"]["flash_bwd"],
                     "sft_bfloat16": qlora_launches["sft_bfloat16"]["flash_bwd"],
                     "grpo_int8": qlora_launches["grpo_int8"]["flash_bwd"]},
                 "rehearsal_launches": {"total": reh["a"]["launches"].get("flash_bwd", 0),
                                        "per_call": {k: sorted({d.get("flash_bwd", 0) for d in v})
                                                     for k, v in reh["a"]["per_call"].items()}},
                 "moe_train_launches": {k: v.get("flash_bwd", 0)
                                        for k, v in moe_train_launches.items()},
                 "two_rank_launches": rank_launches("flash_bwd"),
                 "mesh_launches": mesh["mesh"]["launches"]["flash_bwd"],
                 "grpo_learns_launches": learns["launches"]["flash_bwd"],
                 "tp_launches": tp["launches"]["bwd"],
                 "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
                 "ms": sft["ms"], "plain_ms": sft["plain_ms"], "bound_ms": sft["bound_ms"],
                 "bound_by": sft["bound_by"], "library_ms": sft["library_ms"],
                 "at_shape": sft["shape"],
                 "build": {fn: r for fn, r in built.items()
                           if any(f"flash_bwd_{k}kernel" in fn for k in ("", "prep_", "convert_"))},
                 "shapes": bwd_rows}
    # the banded kernels at the long-DNA encoder's shape, launches from the
    # long-DNA trainer's timed steps
    local_entries = []
    for kind, replaces, also in (("fwd", "bioreason_tpu/ops/local_attention.py:46", []),
                                 ("bwd", "bioreason_tpu/ops/local_attention.py:95",
                                  ["bioreason_tpu/ops/local_attention.py:133"])):
        mine = [r for r in band_rows if r["kernel"] == f"local_{kind}"]
        at = next(r for r in mine if r["shape"].startswith("encoder_long"))
        local_entries.append({
            "name": f"local_{kind}", "route": "cuda",
            "source": f"bioreason_tpu_torch/csrc/flash_{kind}.cu", "replaces": replaces,
            "also_replaces": also, "launches": long[f"local_{kind}"],
            "two_rank_launches": rank_launches(f"local_{kind}"),
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "at_shape": at["shape"],
            "build": {fn: r for fn, r in built.items() if f"local_{kind}_kernel" in fn},
            "shapes": mine})
    # the fp32 kernels at the rehearsal's SFT step shape, launches from the
    # fp32 phase's train_sft run (the route that raised before them)
    f32_entries = []
    for kind, replaces, also in (
            ("fwd", "bioreason_tpu/ops/flash_attention.py:60",
             ["bioreason_tpu/ops/flash_attention.py:239", "bioreason_tpu/ops/local_attention.py:46"]),
            ("bwd", "bioreason_tpu/ops/flash_attention.py:118",
             ["bioreason_tpu/ops/flash_attention.py:160", "bioreason_tpu/ops/flash_attention.py:271",
              "bioreason_tpu/ops/local_attention.py:95", "bioreason_tpu/ops/local_attention.py:133"])):
        name = f"flash_f32_{kind}"
        mine = [r for r in f32_rows if r["kernel"] == name]
        at = next(r for r in mine if r["shape"].startswith("f32_sft"))
        fns = (("flash_f32_fwd_kernel",) if kind == "fwd" else
               ("flash_f32_delta_kernel", "flash_f32_dq_kernel", "flash_f32_dkv_kernel"))
        f32_entries.append({
            "name": name, "route": "cuda", "source": "bioreason_tpu_torch/csrc/flash_f32.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": fp32["cli"]["launches"][name],
            "trainer_launches": fp32["trainer"]["kernels"]["launches"][name],
            "api_launches": fp32["api"]["launches"].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "ffma_bound_ms": at["ffma_bound_ms"], "library_ms": at["library_ms"],
            "at_shape": at["shape"],
            "build": {fn: r for fn, r in built.items() if any(f in fn for f in fns)},
            "shapes": mine})
    log(f"evo2 goldens: largest error on the card {golden_err:.3g}")
    log(json.dumps({"kernels": [fwd_entry, bwd_entry, *local_entries, *f32_entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
