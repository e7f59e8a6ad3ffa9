#!/usr/bin/env python3
"""Drive the PyTorch port (``v2ap_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) if it fails:

  1. build   — print the card, compile ``v2ap_torch/csrc/flash_fwd_sm90.cu``
               and ``flash_bwd_sm90.cu`` (the bf16 forward and backward on
               the tensor cores), ``flash_fwd.cu`` and ``flash_bwd.cu`` (the
               f32 forward and backward), ``norms.cu`` (N1, N2) and
               ``quantize.cu`` (Q1, Q2) with nvcc
               for sm_90a (one nvcc each, started together), print the
               build seconds;
  2. kernels — each kernel on the card at its main path's shapes against its
               plain PyTorch version on the same inputs, computed in f32,
               its time printed beside the CUDA-core kernel's
               (``CUDA_CORE_MS``, from PERF.md, by CUDA events as ``ms``):
               K1 (packed) and K2 (4D) forwards, K1 also with logits in
               softclamp's range and at the training shapes of the DPO
               reference forward (8, 782, 16x64 and 8x64; cross-attention
               8, 782x16 with 4-16 keys valid); K3 (forward with lse), K4 (dq) and K5
               (dk, dv) at the training shapes, with logits of std 40, with
               a fully masked batch element (exactly zero gradient) and in
               f32; K2 also at CLIP ViT-L/336's (64, 16, 577, 64) (577
               tokens, the last 64-row tile ragged), timed as the others,
               with batch element 1 fully masked and in f32; K4 and K5
               also at d = 104, ViT-bigG's (64, 257,
               16x104), checked and timed (graph) with softclamp 50 and
               without, and at (8, 782, 16x64) without softclamp (timed);
               N1 (the fused RMS norm) and N2 (the AdaLN-Zero gated
               residual) at the sampler's served shapes, bf16, against
               their plain versions (N1 within one bf16 step, N2
               bit-equal), beside the plain version's events and graph
               times and the bytes bound; Q1 (the int8 quantize) and Q2
               (the dequantize) at ViT-bigG's served shapes, bf16,
               bit-equal to the plain chain, timed as N1 and N2, and one
               int8 ViT-bigG forward of a 64-frame chunk, kernels against
               the plain chain (bit-equal features, both timed, 578 Q1 and
               289 Q2 launches); kernel times two ways: CUDA
               events over 20 calls launched back to back (``ms`` in the
               kernels line, as in every earlier run; the host path bounds
               it from below for the small K1 calls) and replays of a CUDA
               graph of the same 20 calls (``graph_ms``: the card's time
               without the host path); plain times (CUDA events), library
               times (the profiler's device time: compiled flex_attention
               with the softclamp and mask, its backward for K4 + K5, SDPA
               for K2 and for K1 at nk = 1) and the card's least time for the
               same work (bound); the host microseconds of one
               ``flash_attention_packed`` call at (2, 800, 16x64) in bf16
               (three tensor maps a call, from the kernel's map cache) and
               in f32 (the CUDA-core kernel's host path), every sample
               printed;
  3. probe   — the P1 probe (``v2ap_torch.scripts.probe_flash_bnhd``) at its
               defaults, b 24, n 768, 16x64 heads, bf16 from
               numpy.random.default_rng(0): the old path (transposes to
               (b, h, n, d), K2's entry point) and the new one (P1 on the
               packed layout) must agree, both are timed (CUDA events), and
               one new-path call must launch P1 once and nothing else; then
               P1 against its plain version on the new path's inputs: bf16
               (timed, with plain, library and bound), logits of std 40, a
               fully masked batch element, and f32;
  4. small   — a small f32 configuration through the port's entry points on
               the card (kernels) and on the CPU (plain versions), same
               weights and x0: CLIP features, sampled latents and waveform
               must agree; then with a prompt (T5) and a roll from 8 strips
               at strip stride 2 (Video2Roll): context, roll, latents and
               waveform must agree;
  5. generate — the full-width V2A slice: v2a_default() at frame stride 1
               (12 layers, dim 1024, bf16), CLIP ViT-bigG, the full EnCodec,
               random weights from seed 0 made on the device, bf16 towers;
               a 10 s clip of seeded 224x224 uint8 frames at 25 fps through
               ``V2APipeline.generate`` with an empty prompt, 25 steps and
               cfg_strength 2.0, once to warm up (which captures the
               sampler's CUDA graph; its cost is printed) and then
               GENERATE_RUNS times timed (every wall, the median, stage
               medians, the realtime factor). The launch counters are
               zeroed just before each timed run and read just after: K2
               must run 48 x (tower chunks) times in each, K1 (steps-1) x
               48 = 1152 times, N1 (steps-1) x 85 = 2040 and N2 (steps-1)
               x 36 = 864 (the replayed sampler program's, which its
               capture recorded) and no other kernel;
  6. profile — one more generate under the profiler, the counters zeroed
               just before it and read just after: CUDA time by kernel
               group and by kernel, its share of that run's wall,
               host-launched kernels against CUDA-graph launches; it fails
               unless the tensor-core forward ran (d 104 and d 64), no bf16
               instance of the CUDA-core forward did, K2 ran 48 x (tower
               chunks) times by the counters and K1 (steps-1) x 48 = 1152
               times, N1 2040 and N2 864 by the trace and by the counters;
  7. captured — the full-width sampler as captured programs against the
               same CFM run eagerly on the same x0 and conditioning: the
               25-step CFG sampler, 4 few-step steps and two restart passes
               must give bit-equal latents (capture and replay), walls
               printed;
  8. batch   — ``generate_batch`` over BATCH 10 s clips handed in decoded,
               x0 from the seeds of each clip's own ``generate``: warm-up
               (a new capture), BATCH_RUNS timed calls (walls, audio-s per
               wall-s, host launch counts checked), each row within
               BATCH_REL_RMS of its clip's ``generate``;
  9. long    — ``pipelines.merge.generate_long`` over a LONG_S clip of
               seeded frames: three chunks in one batched call, the
               clip's length of finite audio, walls;
  10. http   — the port's HTTP server on 127.0.0.1, port 0: BATCH
               concurrent ``POST /v2a`` answered by ONE ``generate_batch``
               call, each a 200 with 240 000 samples at 24 kHz; /healthz
               and /metrics; per-request latency. The uploads do not decode
               on this machine (no cv2), so it is the unconditioned route,
               as JAX serves a clip it cannot decode. Then mixed traffic:
               waves of MIXED_WAVES concurrent POSTs (one call each, batch
               sizes padded to powers of two) and requests at
               MIXED_DURATIONS handed to the server's batcher as a decoded
               clip's duration would be; no key may be captured twice
               (no recapture) and the programs must fit MAX_PROGRAMS;
               each capture's cost and pool memory printed;
  11. V2P generate — v2a_default() as shipped (frame stride 3, strip stride
               2) with FLAN-T5-large and Video2Roll: the same frames, 250
               seeded 100x900 uint8 keyboard strips through
               ``strips_cache``, a prompt of PROMPT_TOKENS tokens,
               ``piano=True``; timed as phase 5. K1 must run 1152 times
               (prompt cross-attention at nk = 64), N1 2040, N2 864 and K2
               96 (84 frames at stride 3, two chunks), no other kernel;
               the roll must be finite, in [0, 1] and not all zero;
  12. V2P profile — as phase 6, convolutions (Video2Roll, EnCodec) as a
               group of their own;
  13. small train — one train step of tiny_test() (f32, dropout 0, the
               loss's draws made on the CPU) on the card and on the CPU from
               the same weights: loss, every gradient and the updated
               parameters must agree; then 20 steps on the card (lr 1e-3,
               warmup 2, one batch, fixed draws): the loss must fall;
  14. train  — the full-width V2A training step: v2a_default() (12 layers,
               dim 1024, bf16 compute, f32 params, dropout 0.1), AdamW with
               TrainConfig() defaults and EMA, random weights from seed 0,
               a synthetic batch from seed 0 (TRAIN_BATCH x 750 latents,
               782 tokens with the registers, prompt context of 16 with
               4-16 valid). One warm-up step, then TRAIN_STEPS timed ones,
               the launch counters zeroed before each and read after:
               K3, K4 and K5 must run 48 times each per step, K1 and K2
               not at all; loss and gradient norm finite; parameters and
               EMA moved. Median step time, audio-seconds per second, peak
               memory. Then ``ModelConfig.remat`` on, policies "full" and
               "dots", on the same trainer and batch: a warm-up step, a
               timed one (wall, peak memory) and a profiled one (kernel
               time, busy share, host-launched kernels); K3 must run twice
               as often as without remat (the recompute runs each
               attention again), K4 and K5 as often;
  15. train profile — CUDA time by kernel group over one more train step,
               failing as phase 6 does, and unless the tensor-core backward
               (K4, K5 at d 64) ran and no CUDA-core backward kernel did;
  16. corpus train — a seeded corpus under a temporary directory in the
               default corpora's layout (10 s 24 kHz wavs in two .scp
               manifests, one of sound effects; two vggsound rows and one
               piano row whose .mp4 paths do not exist, with sibling wavs,
               the piano row's .3.npy roll, and feature and strip caches
               primed through the pipeline from seeded frames and strips,
               since this machine has no cv2); ``TrainingPipeline`` over
               v2a_default() with remat "dots" (the CLI's default), EMA and
               a checkpoint every CORPUS_SAVE_STEP steps (one kept): ``fit``
               takes one warm-up step and CORPUS_STEPS timed ones at batch
               TRAIN_BATCH x 750 latents. Per step: the ``device_batch``
               wall (EnCodec encode, T5, cache reads) and the train step's
               apart, loss / flow / MIDI loss, launches; medians,
               training audio-s per s, peak memory, each checkpoint's bytes
               and seconds. Fails unless the losses are finite, a batch had
               the piano row and its MIDI loss was nonzero, every video
               row had CLIP features and the piano row strips, the
               checkpoints were written at steps 3 and 6, metrics.jsonl
               holds every step and heartbeat.json the last, each step
               launched K3 96 times and K4, K5 48, and every flash backward
               took the tensor-core route;
  17. resume and serve — a fresh ``TrainingPipeline`` on the same work dir
               resumes at step 6 with parameters, buffers, AdamW moments,
               EMA and the dropout generator bit-equal to the pipeline that
               saved them (restore seconds and bytes), then takes one step
               on the next batch with the piano row, under the profiler
               (kernel groups; fails as phase 15 does, or on a zero MIDI
               loss);
               ``save_model`` writes its EMA CFM to ``serve/cfm``; a fresh
               serving pipeline (phase 5's configuration) must return
               ["cfm"] from ``load_weights`` and generate, from phase 5's
               frames and x0, latents and audio bit-equal to those of a
               pipeline given the same float32 state before
               ``cast_params``. The temporary directory is removed;
  18a. DPO   — phase 14's trainer and batch (rows 6 and 7 a preference
               pair) with ``TrainConfig(dpo=True)`` (EMA on, the shadow is
               the reference model): the first step's DPO term must be
               within 1e-2 of ln 2 (the shadow equals the model and draws
               the policy's dropout masks), then DPO_STEPS timed steps,
               each launching K1 48 times (the reference forward, no
               autograd) and K3, K4, K5 48 times, every term finite; wall,
               peak memory, and one step under the profiler (tensor-core
               kernels only, busy share, host launches);
  18b. FactorCL — the same for ``variant_preset("crossatt6")`` with DPO
               under remat "dots" (K3 96 a step): the contrastive term
               finite and nonzero, FactorCL's parameters moved, and the
               layer-1 hiddens returned by layer 1's checkpointed call
               (and by no other layer's);
  19. reflow — the full-width teacher draws REFLOW_BATCH x REFLOW_LATENTS
               pairs with its 25-step sway CFG sampler (K1 1152, N1 2040,
               N2 864 a batch),
               the student takes REFLOW_STEPS distill steps (K3-K5 48
               each); ``save_model``, a serving pipeline's
               ``load_weights`` and ``generate(fewstep=2)``: finite audio of
               the clip's length; seconds per pair batch and per step;
  20. reference layout — a full-width synthetic crossatt3 ``.pt`` (the
               keys and shapes of ``reference_manifest``) through ``python
               -m v2ap_torch.convert``, a strict load leaving no key, the
               permuted q rows, ``load_weights`` and one V2A generate; the
               ``.pt`` removed; a crossatt6 state dict into a seeded
               crossatt6 CFM leaves only FactorCL's keys and zeroes
               ``to_frames`` and ``proj_frames``. Load seconds printed;
  21. evaluate — PANN Cnn14 (``pann_16k()``, 527 classes) and CLAP
               (``clap_htsat_unfused()``) from seeded weights on the card
               and on the CPU, same weights, a seeded 10 s clip and a
               caption: embedding, logits, audio and text features within
               EVAL_REL_RMS, the similarity within EVAL_SIM_ATOL; ms per
               clip on the card (CUDA events, median of EVAL_REPS). Then
               ``V2APConfig()`` (the CLIs' configuration) over a seeded
               manifest of EVAL_CLIPS absent .mp4 rows: ``run_batch_eval``
               in this process with the decoded frames handed in (K2 48 x
               (tower chunks) per clip by the counters, K1, N1 and N2 the
               replay's, nothing else from the host; the tower primes the
               feature caches), after a V2P generate that primes the piano
               row's features and roll;
               then ``python -m v2ap_torch.evaluate --steps 25 --ref-dir
               --clap`` and ``python -m v2ap_torch.inference_v2p`` (the
               positional form, a saved CFM as its checkpoint) as their own
               processes from those caches: both exit 0, every row
               succeeded, FAD / IS / KL finite, a CLAP score in [-1, 1] per
               clip, 240 000 finite samples a wav; walls, realtime factors
               and the metrics' seconds printed.
  22. towers — the other video encoders. Small: a "mixed" pipeline of four
               small f32 towers (``tower_small_configs``: CLIP-like at head
               dims 32 and 64, quick GELU for the ViT-L one, the tiny
               DINOv2 and ConvNeXt) on the card and on the CPU, same
               weights: each tower's features of the same frames within
               SMALL_REL_RMS, K2 run for both CLIP towers; DINOv2-giant's
               bf16 attention layer card vs CPU within 2^-8. Full width:
               v2a_default() with ``video_encoder="mixed"`` and
               dim_text_raw 4608 (ViT-bigG 224px, ViT-L/14-336 336px,
               ConvNeXt-XXLarge 256px, DINOv2-giant 224px, bf16, random
               weights from seed 0), frame stride 1, phase 5's frames
               through ``frames_cache`` (resized per tower on the card), an
               empty prompt, 25 steps: a warm-up and TOWER_RUNS timed
               generates (every wall, ``video_encode_s`` by tower, the
               realtime factor, peak memory), K2 (48 + 24) x 4 chunks per
               run and no other wrapper, finite audio of the clip's length;
               then the same at 1280x720 frames (a warm-up and one
               timed generate: every tower resizes on the card), and one
               ``clip_vit2`` generate: K2 24 x 4;
  23. Audeo  — float32, TF32 off (printed beside every time). Card against
               CPU from the same weights: one ``Video2RollTrainer`` step
               at batch 2 of 5 x 100 x 900 windows (loss, logits, every
               BatchNorm running statistic) and one ``Roll2MidiTrainer``
               step on 2 x 16 x 24 windows with every dropout rate 0 (the
               G losses, G's statistics; the D loss against float64 at the
               card's updated G), all within SMALL_REL_RMS; each gradient
               tensor of the card and of the CPU against a float64 copy on
               the card, and the card's against the CPU's, within
               GRAD_MAX; the card's parameters must be Adam's first update
               of its own gradients (within 1e-6).
               Full width: ``Video2RollTrainer`` at batch V2R_BATCH, a
               warm-up and AUDEO_STEPS timed steps; ``Roll2MidiTrainer``
               plain and enhance at batch R2M_BATCH x 51 x 100, a warm-up
               and R2M_FALL_STEPS timed steps on one batch, whose
               reconstruction loss must fall (median, windows per second,
               peak memory); then ``video2roll_infer_chunks`` over
               AUDEO_STRIPS seeded strips (5 npz chunks), ``roll2midi_infer``
               (4 chunks: the odd last one dropped), ``MidiSynth``,
               ``write_midi_file`` and ``evaluate_rolls`` against a seeded
               ground truth: finite, binary rolls, a parseable MIDI file,
               walls printed.
  24. weights in and int8 — with ``V2AP_INT8_TOWERS`` unset and the gate
               file pointed at a missing path (JAX's default: int8 towers).
               (a) Seeded tensors under the published key layouts of
               ``tests/golden/hf_keys_*.json``: ViT-bigG (float16, sharded
               ``model-*.safetensors`` with its index, written by this
               script's own writer), FLAN-T5-large's encoder and the 24 kHz
               EnCodec (``weight_g`` / ``weight_v``) in float32,
               DINOv2-giant (518 px) and ConvNeXt-XXLarge in bf16 (each a
               ``pytorch_model.bin``), ViT-L/336 (one float16
               ``model.safetensors``) and Video2Roll (the reference's
               names); ``python -m v2ap_torch.convert --clip --t5 --encodec
               --dinov2 --convnext`` as its own process (seconds per flag,
               no key left over), ViT-L/336 through its reader and
               ``save_model``; a V2A pipeline's ``load_weights`` (seconds):
               every loaded tensor of ViT-bigG, T5, EnCodec and Video2Roll
               bit-equal to the in-process readers' in the pipeline's
               dtype, EnCodec's folded weights against
               ``torch._weight_norm`` on the card (1e-6 of max|w|), a V2A
               generate on the loaded weights and Video2Roll's logits
               finite. (b) One int8 ``Linear`` at ViT-bigG's fc1 card vs CPU
               (codes, scales and int32 sums equal, output within one bf16
               ulp) and timed beside bf16 ``F.linear``; V2A generates with
               int8 towers (the default), bf16 towers and int8 again
               (INT8_RUNS each, launch counts checked, walls and
               ``video_encode_s``), ViT-bigG's features int8 vs bf16; one
               chunk of the int8 tower under the profiler (an int8
               tensor-core GEMM, ``INT8_GEMM``, for each of its 289
               ``Linear`` calls, nothing off the tensor cores) and a
               profiled int8-tower generate (K1 by the trace and the
               counters, K2, Q1 and Q2 by the counters);
               ``v2ap_torch.scripts.probe_tower_drift``'s ``main`` (f32,
               bf16, int8, int8_mlp, int8_skip_last4); a mixed
               pipeline through ``Predictor(...).setup(ckpt=)``, its four
               towers bit-equal to the readers', INT8_MIXED_RUNS generates
               in int8 and in bf16; ``V2AP_INT8_CFM=1``: every ``Linear``
               of the CFM in int8, the captured 25-step sampler bit-equal
               to the eager one and its replay counting the eager
               sampler's Q1 and Q2 launches, INT8_RUNS generates
               (``sample_s``). (c)
               ``python -m v2ap_torch.int8_tower_gate --tiny`` writes its
               verdict file (plumbing: seeded evaluators, a clip that does
               not decode here).
  25. AudioLDM, vocoders, the token path — float32 unless said, TF32 off.
               (a) A small AudioLDM stack (two-level 32-channel UNet, tiny
               CLAP, VAE and HiFi-GAN) on the card against the CPU, same
               weights, x_t and per-step noise, 10 DDIM steps at eta 0 and
               0.5: latents and waveform within SMALL_REL_RMS. Then
               ``AudioLDMBackend(ldm_s_full())`` with the default CLAP, VAE
               and HiFi-GAN from seeded weights (zero-initialised tensors
               seeded too), the two AUDIOLDM_PROMPTS through CLAP's
               fallback tokenizer against "": a warm-up and AUDIOLDM_RUNS
               timed ``text_to_audio`` calls (25 DDIM steps, guidance 2.5,
               eta 0), no flash wrapper counting in any; the waveform
               (2, 163 872) (HiFi-GAN's 160 x 1024 + 32 samples), finite,
               not all zero; the stages (CLAP, DDIM, VAE decode, HiFi-GAN)
               timed one by one over AUDIOLDM_RUNS more runs, whose
               waveform must be within SMALL_PARAM_REL_RMS of
               ``text_to_audio``'s (the same calls; cuDNN may choose
               another algorithm); one more ``text_to_audio`` under the
               profiler (kernel groups, busy share, host launches). (b) Vocos at
               ``vocos_mel_24khz()`` on a seeded 938-frame mel (239 872
               samples): ``istft`` against the loop-and-scatter overlap-add
               and the card against the CPU within VOCOS_REL_RMS; ms per
               clip. (c) ``VaeVocoder.decode`` of seeded (2, 750, 128)
               latents at the default widths: finite, 480 032 samples a
               row, ms. (d) ``DurationPredictor`` at v2a_default()'s
               transformer (12 layers, bf16 compute, f32 params), byte
               tokens, PRED_BATCH x 750 latents: first a small f32 config
               card vs CPU (prediction, loss with ``frac`` handed in, every
               gradient, SMALL_REL_RMS); then PRED_FWD_REPS timed forwards,
               each launching K1 48 times (4 attentions a layer: audio
               self, audio cross run over the audio stream, text, frames),
               N1 85 and N2 36 times and nothing else; a warm-up and
               PRED_STEPS timed loss + backward + AdamW steps, each K3,
               K4, K5 48 times and no K1, peak memory; one forward + backward
               under the profiler, failing unless
               ``flash_fwd_sm90_kernel<64>`` and the ``flash_bwd_*_sm90``
               kernels ran and no CUDA-core one.

  26. parallelism, the wire modes, determinism — (a) on phase 5's
               pipeline: ``assert_deterministic`` on the captured 25-step
               sampler; ViT-bigG's features with ``V2AP_SHIP_YUV420`` (the
               tower's geometry and the 4:2:0 pack on the host, the unpack
               on the card) against RGB, the drift and walls printed;
               ``shard_serving(make_mesh(MeshConfig()))`` over a
               process group of this process alone under NCCL, then
               ``generate``: bit-equal to the plain generate, the sampler
               captured anew (one capture), the launches of phase 5. On
               phase 11's pipeline: the roll of 251 strips shipped
               strip-half against exact strips (drift, walls). After
               phase 15: a fresh v2a_default() CFM from seed 0 and phase
               14's batch: its eager 25-step sample and one train step
               (the references of (b), written under the temporary
               directory);
               ``assert_deterministic`` on the step (the loss and each
               updated tensor's float64 sum, runs 2); the step through
               ``Trainer(mesh=)`` on a world-1 NCCL mesh bit-equal to the
               plain one (loss, every clipped gradient, every updated
               tensor). (b) In the background of phase 24a (whose walls
               are therefore not taken): two ranks
               (``chip_smoke.py --tp-rank r``) sharing the card through
               gloo over CUDA tensors at TP 2, each building the same
               seeded models: ViT-bigG over 64 frames (K2 48 at the
               TP-local (64, 8, 257, 104); features within TP_FEAT_REL),
               the 25-step sample (K1 1152, N1 2040, N2 864 on the
               replicated rows; latents within TP_LAT_REL),
               one train step (K3, K4, K5 48 each; each clipped gradient
               within TP_GRAD_REL; the worst change of a tensor in the
               step and the worst updated weight printed),
               walls and each rank's peak memory; and
               beside them ``python -m v2ap_torch.parallel.dryrun
               --world-size 2 --model-parallel 2 --device cuda --backend
               gloo`` (f32, every phase, its own checks). Phase 2 also
               holds K2 at the TP-local shape against its plain version.

  27. host library and tokenizers — (a) after phase 4: the host library
               (``v2ap_torch/native``) built with g++ on the card's host;
               ``read_wav`` of 16-, 24- and 32-bit PCM, 32-bit float and
               EXTENSIBLE WAVs bit-equal to the samples they were written
               from, ``max_energy_start`` to its plain prefix sum,
               ``clip_preprocess_batch`` (``preprocess_frames``) at 224 from
               phase 5's frames and from HD_FRAMES 1280x720 ones to
               ``resize_center_crop`` on the card, ``pack_yuv420`` within 1
               LSB of its numpy version; host walls, each beside the card
               line: the native against the numpy pack over phase 5's 250
               frames, the native host geometry against the card's GEMMs
               (and the upload) from 1280x720. Phase 26a's YUV features go
               through this pack. (b) after phase 26a's strips: the
               committed tokenizer directories (``tests/golden/
               tokenizers``) encode the golden prompts to the ids
               ``transformers`` gave (``tests/golden/tokenizer_ids.json``);
               a V2P pipeline built with ``tokenizer_path=`` the golden T5
               directory generates with PROMPT: a new sampler capture keyed
               on the prompt's width (not 64), whose eager warm-up (one CFG
               eval) launches K1 ``k1_expect / 24`` times by the counters
               before its first replay's ``k1_expect``, and a replay
               bit-equal to the capturing call. Phase 2 holds
               K1 at that width (no library yardstick).

``python3 chip_smoke.py --tp-limits`` runs only phase 26's references and
(b), once as it is and once with each planted fault of ``plant_tp_fault``,
and prints the readings the limits of (b) are set between (no result
line).

Each phase header line carries the seconds since the start of the run.

The line before the last is a JSON object with one entry per kernel (K1-K5,
P1, N1, N2, Q1 and Q2; the launches of K1/K2 from the profiled V2A
generate, K1's counted in its trace and by the replays of its sampler
program, K2's by its wrapper, of Q1 and Q2 from phase 24b's profiled
int8-tower generate (the default precision), of K3-K5 from one train step, of P1 from one new-path probe call), a second K2
entry for its case at CLIP ViT-L/336's shape (the launches of phase 22's
clip_vit2 generate) and a third at TP 2's local heads (the launches of a
rank's sharded ViT-bigG chunk, phase 26b), each naming its ``case``; the
last is {"ok": true, "device": {...}}. Without CUDA, or without the repo
around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
# bf16 kernel output vs the f32 plain version: |err| <= KERNEL_RTOL *
# max(1, max|ref|). Rounding the output costs half a bf16 ulp, at most
# 2^-8 |o| (K2 read 3.648e-3 at 1 <= |o| < 2, K1 1.539e-3); rounding P to
# bf16 before P.V costs at most 2^-9 max|v| spread over a row's weights.
# K3-K5 read at most 3.1e-3 max|ref| (K5 with logits of std 40: 2.781e-2
# at max|ref| 9.065; the cross-attention's dk 5.784e-2 at 24.62), inside
# the half-ulp 2^-8 max|ref| of their bf16 outputs.
KERNEL_RTOL = 2.0 ** -7
# f32 kernel vs f32 plain version: |err| <= F32_RTOL * max(1, max|ref|)
# (summation order and expf only)
F32_RTOL = 1e-4
LSE_ATOL = 1e-3                    # lse of bf16 inputs, f32 either way
SOFTCLAMP_Q_GAIN = 40.0            # logits of std 40: softclamp's own range
SMALL_REL_RMS = 1e-3               # f32 card vs CPU, other summation orders
# updated parameters, card vs CPU: Adam's first update is +-lr g/|g|, so an
# element whose gradient is at rounding level may move by 2 lr the other
# way; over all parameters (scale ~0.05) that stays far below this
SMALL_PARAM_REL_RMS = 1e-5
CLIP_S = 10.0
FPS = 25
GENERATE_RUNS = 4                  # timed full-width generates (median)
TRAIN_BATCH = 8                    # TrainConfig.batch_size
TRAIN_LATENTS = 750                # DataConfig.target_length, 10 s at 75 Hz
TRAIN_CONTEXT = 16                 # prompt tokens, as scripts/bench_train.py
TRAIN_STEPS = 5                    # timed full-width train steps (median)
CORPUS_STEPS = 5                   # timed corpus train steps after a warm-up
CORPUS_SAVE_STEP = 3               # checkpoints at steps 3 and 6
CORPUS_WAVS = 4                    # 10 s wavs in each audio manifest
TINY_STEPS = 20                    # tiny loss-falls check (scripts/train_smoke.py)
BATCH = 4                          # clips of a generate_batch, HTTP requests
BATCH_RUNS = 2                     # timed generate_batch calls (median)
# a batch row vs its clip's single generate: read 7.470e-07 to 7.482e-07
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), about 130x below this
BATCH_REL_RMS = 1e-4
LONG_S = 25.0                      # generate_long clip: three 10 s chunks
HTTP_WINDOW_MS = 2000.0            # the batcher's window for the HTTP phase
MIXED_WAVES = (1, 3, 2, 4)         # concurrent POSTs a wave, mixed traffic
MIXED_DURATIONS = (5.0, 20.0, 5.0)  # seconds, through the server's batcher
PROBE_SHAPE = (24, 768, 16, 64)    # the P1 probe's defaults: b, n, h, d
K2_CLIP_L = "K2 CLIP ViT-L/336 (64, 16, 577, 64)"
K2_TP = "K2 ViT-bigG TP-local (64, 8, 257, 104)"   # 16 heads over 2 ranks
PROBE_REPS = 20
# ten words: with the end token, PROMPT_TOKENS of the tokenizer's 64 tokens
PROMPT = "a gentle piano melody over soft rain on a window"
PROMPT_TOKENS = 11
HOST_CALLS = 200                   # calls per host-time sample
GOLDEN = os.path.join(ROOT, "tests", "golden")
T5_TOKENIZER = os.path.join(GOLDEN, "tokenizers", "t5")
HD_FRAMES = 32                     # 1280x720 frames of phase 27a's geometry
HOST_WALL_REPS = 2                 # alternating timed runs of each route
HOST_ROUNDS = 6                    # host-time samples per dtype
# bf16 times of the CUDA-core kernels that the tensor-core ones replaced
# (CUDA events, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, the bracketed
# times of its kernel table), beside which this run's are printed
CUDA_CORE_MS = {"K1 self-attn (2, 800, 16x64)": 0.4405,
          "K1 roll self-attn (2, 800, 8x64)": 0.2378,
          "K1 cross-attn nk=1 (2, 800x1, 16x64)": 0.0733,
          f"K1 cross-attn nk=64, {PROMPT_TOKENS} valid (2, 800x64, 16x64)":
              0.0597,
          "K2 ViT-bigG (64, 16, 257, 104)": 2.1703,
          "K2 ViT-bigG stride-3 tail chunk (20, 16, 257, 104)": 0.7428,
          "K3 self-attn (8, 782, 16x64)": 1.4995,
          "K3 roll self-attn (8, 782, 8x64)": 0.7726,
          "K3 cross-attn (8, 782x16, 16x64), context 4-16 valid": 0.1051,
          "K4 self-attn (8, 782, 16x64)": 2.2247,
          "K4 roll self-attn (8, 782, 8x64)": 1.1250,
          "K4 cross-attn (8, 782x16, 16x64), context 4-16 valid": 0.1655,
          "K5 self-attn (8, 782, 16x64)": 2.5115,
          "K5 roll self-attn (8, 782, 8x64)": 1.3833,
          "K5 cross-attn (8, 782x16, 16x64), context 4-16 valid": 0.3000,
          "P1 probe (24, 768, 16x64)": 3.7544}


T_START = time.perf_counter()


def log(*args) -> None:
    if args and str(args[0]).startswith("["):      # a phase header
        args = (f"{args[0]} (t = {time.perf_counter() - T_START:.1f} s)",
                *args[1:])
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Time on the card of one ``fn()`` without its host path: ``iters``
    calls captured in a CUDA graph, the graph replayed ``replays`` times
    between CUDA events, over the calls. The kernels' wrappers launch on
    the current stream, so capture records their kernels as they are."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def vs_cuda_core(label: str, ms: float) -> str:
    """This run's time beside the CUDA-core kernel's for the same row."""
    old = CUDA_CORE_MS.get(label)
    return ("CUDA cores n/a" if old is None
            else f"CUDA cores {old:.4f} ms, {old / ms:.1f}x as fast")


def kernel_rows(prof) -> list:
    """The profiler's rows for CUDA kernels, without the user annotations
    (e.g. ``Optimizer.step#AdamW.step``) that it also puts on the device
    timeline and that would count their kernels twice."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def device_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Device time of one call: the CUDA kernels' durations summed over
    ``iters`` calls under the profiler, over ``iters``. Host gaps between
    launches do not count, so a call whose wall time is its host overhead
    reads its device work. Fails if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profiler run may come back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in kernel_rows(prof))
        if total:
            return total / 1e3 / iters
    raise RuntimeError("the profiler recorded no device time")


def rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    den = b.pow(2).mean().sqrt()
    num = (a - b).pow(2).mean().sqrt()
    if den == 0:
        return 0.0 if num == 0 else float("inf")
    return float((num / den).item())


# --------------------------------------------------------------- phase 2

def kernel_cases(torch):
    """(label, kernel id, kernel call, plain call, library call or None,
    q, k, v, mask) at the main path's shapes, bf16, from a seeded
    generator on the card. q/k/v are the strided views the path passes."""
    from v2ap_torch.ops import flash_attention as fa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # the serving bucket: 768 latents + 32 registers, 750 + 32 valid
    mask = (torch.arange(800, device=dev) < 782)[None].expand(2, 800).contiguous()
    cases = []
    for label, heads, gain in (
            ("K1 self-attn (2, 800, 16x64)", 16, 1.0),
            ("K1 roll self-attn (2, 800, 8x64)", 8, 1.0),
            ("K1 self-attn, logits std 40 (2, 800, 16x64)", 16,
             SOFTCLAMP_Q_GAIN)):
        qkv = rnd(2, 800, 3 * heads * 64)                      # fused qkv
        qkv[..., :heads * 64] *= gain       # |s| up to ~150: tanh bends
        q, k, v = qkv.chunk(3, dim=-1)
        cases.append((label, "K1", q, k, v, mask, dict(heads=heads)))
    ones = torch.ones(2, 1, dtype=torch.bool, device=dev)
    cases.append(("K1 cross-attn nk=1 (2, 800x1, 16x64)", "K1",
                  rnd(2, 800, 1024), rnd(2, 1, 1024), rnd(2, 1, 1024), ones,
                  dict(heads=16)))
    # a prompt's T5 context: the tokenizer's 64 tokens, PROMPT_TOKENS valid
    prompt = (torch.arange(64, device=dev) < PROMPT_TOKENS)[None].expand(
        2, 64).contiguous()
    kv = rnd(2, 64, 2048)                       # to_k / to_v of the context
    cases.append((f"K1 cross-attn nk=64, {PROMPT_TOKENS} valid "
                  "(2, 800x64, 16x64)", "K1", rnd(2, 800, 1024),
                  *kv.chunk(2, dim=-1), prompt, dict(heads=16)))
    # the same prompt through the committed T5 tokenizer (phase 27b): one
    # prompt, so every one of its tokens is valid. No library yardstick:
    # compiling flex_attention for one more shape costs ~20 s of the run
    width = golden_prompt_width()
    kv = rnd(2, width, 2048)
    cases.append((k1_prompt_label(width), "K1", rnd(2, 800, 1024),
                  *kv.chunk(2, dim=-1),
                  torch.ones(2, width, dtype=torch.bool, device=dev),
                  dict(heads=16, library=False)))
    # the DPO reference forward (phases 18a-b): K1 at the training shapes,
    # 750 latents + 32 registers, and the prompt context with 4-16 valid
    n, tb = TRAIN_LATENTS + 32, TRAIN_BATCH
    full = torch.ones(tb, n, dtype=torch.bool, device=dev)
    for label, heads in ((f"K1 self-attn, training ({tb}, {n}, 16x64)", 16),
                         (f"K1 roll self-attn, training ({tb}, {n}, 8x64)",
                          8)):
        q, k, v = rnd(tb, n, 3 * heads * 64).chunk(3, dim=-1)
        cases.append((label, "K1", q, k, v, full, dict(heads=heads)))
    ctx_len = torch.randint(4, TRAIN_CONTEXT + 1, (tb,), generator=gen,
                            device=dev)
    ctx_mask = torch.arange(TRAIN_CONTEXT, device=dev)[None] < ctx_len[:, None]
    kv = rnd(tb, TRAIN_CONTEXT, 2048)
    cases.append((f"K1 cross-attn, training ({tb}, {n}x{TRAIN_CONTEXT}, "
                  f"16x64), context 4-{TRAIN_CONTEXT} valid", "K1",
                  rnd(tb, n, 1024), *kv.chunk(2, dim=-1), ctx_mask,
                  dict(heads=16)))
    for label, nb, n, dh, nh in (
            ("K2 ViT-bigG (64, 16, 257, 104)", 64, 257, 104, 16),
            ("K2 ViT-bigG stride-3 tail chunk (20, 16, 257, 104)", 84 - 64,
             257, 104, 16),
            (K2_CLIP_L, 64, 577, 64, 16),
            (K2_TP, 64, 257, 104, 8)):
        q, k, v = (rnd(nb, n, nh * dh).unflatten(-1, (nh, dh)).transpose(1, 2)
                   for _ in range(3))
        cases.append((label, "K2", q, k, v, None, {}))

    out = []
    for label, kid, q, k, v, m, kw in cases:
        if kid == "K1":
            h = kw["heads"]

            def run(q=q, k=k, v=v, m=m, h=h):
                return fa.flash_attention_packed(q, k, v, m, heads=h,
                                                 dim_head=64, softclamp=50.0)

            def plain(q=q, k=k, v=v, m=m, h=h):
                un = [fa._heads_view(t, h, 64) for t in (q, k, v)]
                return fa.attention_reference(*un, m, softclamp=50.0
                                              ).transpose(1, 2).flatten(2)

            def ref32(q=q, k=k, v=v, m=m, h=h):
                un = [fa._heads_view(t.float(), h, 64) for t in (q, k, v)]
                return fa.attention_reference(*un, m, softclamp=50.0
                                              ).transpose(1, 2).flatten(2)

            if not kw.get("library", True):
                library = None
            elif k.shape[1] > 1:
                library = flex_softclamp(torch, q, k, v, m, h)
            else:       # one key: its weight is 1 whatever the softclamp
                def library(q=q, k=k, v=v, h=h):
                    return torch.nn.functional.scaled_dot_product_attention(
                        *(fa._heads_view(t, h, 64) for t in (q, k, v)),
                        scale=64 ** -0.5).transpose(1, 2).flatten(2)
            shape = (q.shape[0], h, q.shape[1], k.shape[1], 64)
        else:
            scale = q.shape[-1] ** -0.5

            def run(q=q, k=k, v=v, scale=scale):
                return fa.flash_attention(q, k, v, scale=scale)

            def plain(q=q, k=k, v=v, scale=scale):
                return fa.attention_reference(q, k, v, scale=scale)

            def ref32(q=q, k=k, v=v, scale=scale):
                return fa.attention_reference(q.float(), k.float(), v.float(),
                                              scale=scale)

            def library(q=q, k=k, v=v, scale=scale):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, scale=scale)

            shape = tuple(q.shape[:3]) + (k.shape[2], q.shape[3])
        out.append((label, kid, run, plain, ref32, library, shape, m))
    return out


def golden_prompt_width() -> int:
    """PROMPT's tokens through the committed T5 tokenizer, ``</s>``
    included: the context width of phase 27b's generate."""
    from v2ap_torch.data.hf_tokenizer import load_t5
    return int(load_t5(T5_TOKENIZER)([PROMPT])[0].shape[1])


def k1_prompt_label(width: int) -> str:
    return (f"K1 cross-attn nk={width}, the T5 tokenizer's prompt "
            f"(2, 800x{width}, 16x64)")


def flex_softclamp(torch, q, k, v, mask, heads: int):
    """K1's function as one PyTorch call, a yardstick only: compiled
    ``flex_attention`` with softclamp 50 and then the mask as its score_mod.
    The mask enters as an f32 bias of 0 / -1e30 (a clamped logit added to
    -1e30 rounds to -1e30, so fully masked rows still average v); indexing
    the bool mask in the score_mod instead is many times slower.
    Returns (b, n, h*d); None where this torch lacks flex_attention."""
    try:
        from torch.nn.attention.flex_attention import flex_attention
    except ImportError:
        return None
    flex = torch.compile(flex_attention, dynamic=False)
    from v2ap_torch.ops.flash_attention import NEG_INF, _heads_view

    bias = torch.where(mask, 0.0, NEG_INF).float()

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / 50.0) * 50.0 + bias[b, ki]

    def call():
        out = flex(*(_heads_view(t, heads, 64) for t in (q, k, v)),
                   score_mod=score_mod, scale=64 ** -0.5)
        return out.transpose(1, 2).flatten(2)

    return call


def bound(shape, elem_bytes: int, mask_bytes: int):
    """Least time on the card for one call: each input read once and the
    output written once at the HBM rate, or 4*b*h*nq*nk*d FLOP at the
    dense bf16 rate, whichever is larger."""
    b, h, nq, nk, d = shape
    nbytes = elem_bytes * (2 * b * h * nq * d + 2 * b * h * nk * d) + mask_bytes
    flops = 4.0 * b * h * nq * nk * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", flops)


def phase_kernels(torch) -> dict:
    results = {}
    for label, kid, run, plain, ref32, library, shape, mask in \
            kernel_cases(torch):
        out = run()
        ref = ref32()
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
        ref_max = ref.abs().max().item()
        tol = KERNEL_RTOL * max(1.0, ref_max)
        err = (out.float() - ref).abs().max().item()
        status = "ok" if err <= tol else "FAIL"
        lib_err = None
        if library is not None:
            lib_err = (library().float() - ref).abs().max().item()
            if lib_err > tol:
                raise RuntimeError(f"{label}: library yardstick disagrees "
                                   f"with the plain version ({lib_err:.3e})")
        ms = time_ms(torch, run)
        g_ms = graph_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=5)
        lib_ms = device_ms(torch, library) if library is not None else None
        bound_ms, bound_by, flops = bound(
            shape, 2, mask.numel() if mask is not None else 0)
        log(f"  {label}: max|ref| {ref_max:.3f}, max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {status}; kernel {ms:.4f} ms events "
            f"({vs_cuda_core(label, ms)}), {g_ms:.4f} ms graph "
            f"({flops / g_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"library "
            + ("n/a" if lib_ms is None else
               f"{lib_ms:.4f} ms profiler (max_abs_err {lib_err:.3e})")
            + f", bound {bound_ms:.4f} ms by {bound_by} "
            f"({bound_ms / g_ms:.1%} of bound by graph)")
        if status != "ok":
            raise RuntimeError(f"{label}: kernel disagrees with plain version")
        entry = results.setdefault(kid, dict(cases={}, max_abs_err=0.0))
        entry["cases"][label] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    results["K2_CLIP_L"] = dict(
        cases={K2_CLIP_L: results["K2"]["cases"][K2_CLIP_L]},
        max_abs_err=k2_clip_l_edges(torch))
    results["K2_TP"] = dict(cases={K2_TP: results["K2"]["cases"][K2_TP]},
                            max_abs_err=results["K2"]["max_abs_err"])
    results.update(phase_norm_kernels(torch))
    results.update(phase_int8_kernels(torch))
    log_host_cost(torch)
    return results


def bf16_steps(torch, a, b) -> int:
    """The largest distance in bf16 steps (ulps) between two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def norm_cases(torch) -> list:
    """N1 and N2 at the sampler's served shapes, bf16: a CFG evaluation's
    2 x 800 rows (768 latents and 32 registers) of the audio (1024), CLIP
    (1280) and roll (512) streams, final_norm's x[:, 32:] view and a batch
    of 8 clips' 16 x 800 rows; gains per channel or a strided slot of the
    fused projection.
    Each case: (label, kid, kernel, plain, bytes the call must move)."""
    from v2ap_torch.ops import norms

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rows(b, d, start=0):
        return (torch.randn(b, 800, d, generator=gen, device="cuda") * 3
                ).to(torch.bfloat16)[:, start:]

    fused = torch.randn(16, 12, 6, 1024, generator=gen, device="cuda"
                        ).permute(1, 0, 2, 3)[5]
    cases = []
    for label, b, d, start, per_batch in (
            ("N1 audio (1600, 1024), 1 + gamma", 2, 1024, 0, True),
            ("N1 CLIP stream (1600, 1280), g", 2, 1280, 0, False),
            ("N1 roll stream (1600, 512), g", 2, 512, 0, False),
            ("N1 final_norm x[:, 32:] (1536, 1024), g", 2, 1024, 32, False),
            ("N1 batch of 8 (12800, 1024), 1 + gamma", 16, 1024, 0, True)):
        x = rows(b, d, start)
        g = None if per_batch else torch.randn(d, generator=gen,
                                               device="cuda")
        gamma = fused[:b, 0] if per_batch else None
        gain_bytes = 4 * (b * d if per_batch else d)
        cases.append((label, "N1",
                      functools.partial(norms.rms_norm, x, g, gamma=gamma),
                      functools.partial(norms.rms_norm_reference, x, g,
                                        gamma=gamma),
                      4 * x.numel() + gain_bytes))
    for label, b in (("N2 audio gate (1600, 1024)", 2),
                     ("N2 batch of 8 (12800, 1024)", 16)):
        x, branch, gamma = rows(b, 1024), rows(b, 1024), fused[:b, 1]
        cases.append((label, "N2",
                      functools.partial(norms.gated_residual, x, branch,
                                        gamma),
                      functools.partial(norms.gated_residual_reference, x,
                                        branch, gamma),
                      6 * x.numel() + 4 * b * 1024))
    return cases


def phase_norm_kernels(torch) -> dict:
    """N1 and N2 against their plain versions on the same inputs (N1 within
    one bf16 step, N2 bit-equal), each timed by CUDA events and by graph
    replay beside the plain version's two times and the bytes bound."""
    results = {}
    for label, kid, run, plain, nbytes in norm_cases(torch):
        out, ref = run(), plain()
        torch.cuda.synchronize()
        steps = bf16_steps(torch, out, ref)
        if not torch.isfinite(out).all() or steps > (1 if kid == "N1" else 0):
            raise RuntimeError(f"{label}: kernel {steps} bf16 steps from its "
                               f"plain version")
        err = (out.float() - ref.float()).abs().max().item()
        ms, g_ms = time_ms(torch, run), graph_ms(torch, run)
        plain_ms, plain_g_ms = time_ms(torch, plain), graph_ms(torch, plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {label}: {steps} bf16 steps from plain (max_abs_err "
            f"{err:.3e}); kernel {ms:.4f} ms events, {g_ms:.4f} ms graph "
            f"({nbytes / g_ms / 1e6:.0f} GB/s); plain {plain_ms:.4f} ms "
            f"events, {plain_g_ms:.4f} ms graph; bound {bound_ms:.4f} ms by "
            f"bytes ({bound_ms / g_ms:.1%} of bound by graph)")
        entry = results.setdefault(kid, dict(cases={}, max_abs_err=0.0))
        entry["cases"][label] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                     plain_graph_ms=plain_g_ms,
                                     library_ms=None, bound_ms=bound_ms,
                                     bound_by="bytes")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return results


# ViT-bigG's int8 products on a 64-frame chunk (64 x 257 tokens) and on the
# 20-frame tail of a 10 s clip at frame stride 3; (m, k, n)
INT8_SHAPES = (("q/k/v/o", 16448, 1664, 1664), ("fc1", 16448, 1664, 8192),
               ("fc2", 16448, 8192, 1664), ("tail fc1", 5140, 1664, 8192),
               ("tail fc2", 5140, 8192, 1664),
               ("visual_projection", 64, 1664, 1280))
INT8_CHUNK_FRAMES = 64


def int8_cases(torch) -> list:
    """Q1 and Q2 at ViT-bigG's served shapes, bf16: Q1 on each product's
    activations and on its weight, Q2 from its int32 sums with the bias.
    Each case: (label, kid, kernel, plain, bytes the call must move, check
    that the kernel's output equals the plain version's)."""
    from v2ap_torch.utils import quantize as q

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf = torch.bfloat16
    cases, weights = [], set()

    def q1_case(label, t, rows):
        k = t.shape[1]
        kp = -(-k // 8) * 8

        def check(got, want):
            (codes, scale), (ref_codes, ref_scale) = got, want
            return (torch.equal(codes[:t.shape[0], :k], ref_codes)
                    and not codes[t.shape[0]:].any()
                    and torch.equal(scale, ref_scale))
        cases.append((label, "Q1",
                      functools.partial(q.quantize_rows_padded, t, rows),
                      functools.partial(q.quantize_rows, t),
                      t.numel() * 2 + rows * kp + t.shape[0] * 2, check))

    for name, m, k, n in INT8_SHAPES:
        x = (torch.randn(m, k, generator=gen, device="cuda") * 2).to(bf)
        w = (torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5
             ).to(bf)
        b = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(bf)
        q1_case(f"Q1 {name} activations ({m}, {k})", x, max(m, 17))
        if (n, k) not in weights:
            weights.add((n, k))
            q1_case(f"Q1 weight ({n}, {k})", w, -(-n // 8) * 8)
        qx, sx = q.quantize_rows_padded(x, max(m, 17))
        qw, sw = q.quantize_rows_padded(w, -(-n // 8) * 8)
        acc = torch._int_mm(qx, qw.t())
        cases.append((f"Q2 {name} ({m}, {n}) + bias", "Q2",
                      functools.partial(q.dequantize_padded, acc, sx, sw, b,
                                        m, n),
                      functools.partial(q.dequantize, acc[:m, :n], sx, sw,
                                        b),
                      m * n * (4 + 2) + 2 * (m + 2 * n), torch.equal))
    return cases


def int8_chunk_forward(torch) -> None:
    """ViT-bigG in bf16 with int8 Linears (seeded, weights stored in bf16
    as the pipeline serves them) on one 64-frame chunk: the kernels'
    forward against the plain chain's (``layers.int8_linear`` patched to
    ``int8_linear_reference``), bit for bit, both timed by CUDA events;
    the kernels' launches a chunk must be two Q1 and one Q2 for each of
    the 289 int8 Linears."""
    import dataclasses as dc

    import numpy as np

    from v2ap_torch.models.clip_vit import (CLIP_MEAN, CLIP_STD,
                                            CLIPVisionModel, clip_vit_bigg,
                                            device_normalize)
    from v2ap_torch.ops import layers
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.utils import quantize as q
    from v2ap_torch.utils.device import seeded_init
    from v2ap_torch.utils.jitting import cast_params

    with seeded_init(3, torch.device("cuda")):
        tower = CLIPVisionModel(dc.replace(clip_vit_bigg(), dtype="bfloat16"),
                                device="cuda")
    tower.eval().requires_grad_(False)
    cast_params(tower, torch.bfloat16)
    linears = q.quantize_linears_int8(tower)
    px = np.random.default_rng(0).integers(
        0, 255, (INT8_CHUNK_FRAMES, 224, 224, 3), dtype=np.uint8)
    px = device_normalize(torch.from_numpy(px).cuda(), CLIP_MEAN, CLIP_STD)

    def run():
        with torch.inference_mode():
            return tower(px)

    run()
    torch.cuda.synchronize()
    reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    counts = {k: launch_counts[k] for k in ("int8_quantize",
                                             "int8_dequantize")}
    ms = time_ms(torch, run, iters=5, warmup=1)
    layers.int8_linear = q.int8_linear_reference
    try:
        want = run()
        plain_ms = time_ms(torch, run, iters=5, warmup=1)
    finally:
        layers.int8_linear = q.int8_linear
    same = torch.equal(got, want)
    log(f"  int8 ViT-bigG, one {INT8_CHUNK_FRAMES}-frame chunk, {linears} "
        f"int8 Linears: kernels {ms:.2f} ms, plain chain {plain_ms:.2f} ms "
        f"(CUDA events, 5 forwards); features bit-equal {same}; launches "
        f"{counts}")
    if not same or counts != {"int8_quantize": 2 * linears,
                              "int8_dequantize": linears}:
        raise RuntimeError(f"int8 ViT-bigG chunk: kernels and plain chain "
                           f"differ ({same}) or launches {counts} are not "
                           f"2 x and 1 x {linears}")
    del tower
    torch.cuda.empty_cache()


def phase_int8_kernels(torch) -> dict:
    """Q1 and Q2 against their plain versions on the same inputs (bit for
    bit), each timed by CUDA events and by graph replay beside the plain
    version's two times and the bytes bound; then one int8 ViT-bigG chunk,
    kernels against the plain chain."""
    results = {}
    for label, kid, run, plain, nbytes, check in int8_cases(torch):
        if not check(run(), plain()):
            raise RuntimeError(f"{label}: kernel differs from its plain "
                               f"version")
        ms, g_ms = time_ms(torch, run), graph_ms(torch, run)
        plain_ms, plain_g_ms = time_ms(torch, plain), graph_ms(torch, plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {label}: bit-equal to plain; kernel {ms:.4f} ms events, "
            f"{g_ms:.4f} ms graph ({nbytes / g_ms / 1e6:.0f} GB/s); plain "
            f"{plain_ms:.4f} ms events, {plain_g_ms:.4f} ms graph; bound "
            f"{bound_ms:.4f} ms by bytes ({bound_ms / g_ms:.1%} of bound by "
            f"graph)")
        entry = results.setdefault(kid, dict(cases={}, max_abs_err=0.0))
        entry["cases"][label] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                     plain_graph_ms=plain_g_ms,
                                     library_ms=None, bound_ms=bound_ms,
                                     bound_by="bytes")
    int8_chunk_forward(torch)
    return results


def k2_clip_l_edges(torch) -> float:
    """K2 at CLIP ViT-L/336's (64, 16, 577, 64) beyond the timed case: a
    key mask with batch element 1 fully masked (bf16), and float32 (the
    CUDA-core kernel), each against the plain version in float32 (bf16
    2^-7, f32 1e-4, times max(1, max|ref|)). Returns the largest error."""
    from v2ap_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(64, 577, 1024, generator=gen, device="cuda")
               .unflatten(-1, (16, 64)).transpose(1, 2) for _ in range(3))
    dead = torch.ones(64, 577, dtype=torch.bool, device="cuda")
    dead[1] = False
    worst = 0.0
    for label, dtype, mask, rtol in (
            ("K2 CLIP-L, element 1 fully masked (bf16)", torch.bfloat16, dead,
             KERNEL_RTOL),
            ("K2 CLIP-L f32", torch.float32, None, F32_RTOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        out = fa.flash_attention(qq, kk, vv, mask, scale=0.125)
        ref = fa.attention_reference(qq.float(), kk.float(), vv.float(),
                                     mask, scale=0.125)
        torch.cuda.synchronize()
        top = ref.abs().max().item()
        tol = rtol * max(1.0, top)
        err = (out.float() - ref).abs().max().item()
        log(f"  {label}: max|ref| {top:.3f}, max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if not (torch.isfinite(out).all() and err <= tol):
            raise RuntimeError(f"{label}: kernel disagrees with plain version")
        worst = max(worst, err)
    return worst


def log_host_cost(torch) -> None:
    """Host microseconds per ``flash_attention_packed`` call at the serving
    self-attention's (2, 800, 16x64): bf16 (the tensor-core kernel, three
    tensor maps a call) and f32 (the CUDA-core kernel, no tensor
    maps), samples of HOST_CALLS calls taken in turn, every one printed.
    ``v2ap_torch.scripts.host_cost`` sets one checkout against another."""
    import statistics

    from v2ap_torch.ops import flash_attention as fa
    from v2ap_torch.scripts import host_cost

    calls = {dt: host_cost.packed_call(fa, host_cost.DTYPES[dt])
             for dt in ("bf16", "f32")}
    for fn in calls.values():
        fn()
    samples = {dt: [] for dt in calls}
    for r in range(HOST_ROUNDS):
        for dt in (calls if r % 2 == 0 else reversed(list(calls))):
            samples[dt].append(host_cost.sample_us(calls[dt], HOST_CALLS))
    log(f"  host us per flash_attention_packed call (2, 800, 16x64), "
        f"{HOST_ROUNDS} samples of {HOST_CALLS} calls each: " + "; ".join(
            f"{dt} median {statistics.median(xs):.1f} "
            f"({', '.join(f'{x:.1f}' for x in xs)})"
            for dt, xs in samples.items()))


# --------------------------------------------------------------- phase 3

def phase_probe(torch) -> dict:
    """The P1 probe (``v2ap_torch.scripts.probe_flash_bnhd``) at its
    defaults: both paths' parity and median ms (CUDA events), P1's launches
    per ``new_path`` call; then ``flash_bnhd`` on the new path's own inputs
    against its plain version: bf16 (timed, with plain, library and
    bound), logits of std 40, a fully masked batch element, and f32."""
    from v2ap_torch.ops import flash_attention as fa
    from v2ap_torch.ops.rope import apply_rope
    from v2ap_torch.scripts import probe_flash_bnhd as probe

    b, n, h, d = PROBE_SHAPE
    qkv, mask, rot = probe.probe_inputs(b, n, h, d, "cuda")
    old_path, new_path = probe.make_paths(b, n, h, d, rot, mask)
    with torch.inference_mode():
        rel = probe.rel_rms(new_path(qkv), old_path(qkv))
        old_ms = probe.bench(old_path, (qkv,), PROBE_REPS)
        new_ms = probe.bench(new_path, (qkv,), PROBE_REPS)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        new_path(qkv)
        torch.cuda.synchronize()
        counts = dict(fa.launch_counts)
    expect = {**dict.fromkeys(counts, 0), "flash_bnhd": 1}
    log(f"  probe (b {b}, n {n}, {h}x{d}, bf16): parity old vs new rel-RMS "
        f"{rel:.2e}; old bhnd+transposes {old_ms[0]:.4f} ms [{old_ms[1]:.4f}, "
        f"{old_ms[2]:.4f}], new bnhd {new_ms[0]:.4f} ms [{new_ms[1]:.4f}, "
        f"{new_ms[2]:.4f}] (medians of {PROBE_REPS}, CUDA events); launches "
        f"per new_path call {counts}")
    if counts != expect:
        raise RuntimeError(f"probe: new_path launched {counts} != {expect}")
    if not rel < 1e-2:
        raise RuntimeError(f"probe: the two paths disagree ({rel:.2e})")

    # the new path's inputs: rotated packed q, k and v's strided chunk
    q, k, v = qkv.chunk(3, dim=-1)
    q = apply_rope(q.reshape(b, n, h, d), rot, seq_axis=1).flatten(2)
    k = apply_rope(k.reshape(b, n, h, d), rot, seq_axis=1).flatten(2)
    one_dead = mask.clone()
    one_dead[1] = False
    cases = [   # label, q, mask, dtype, timed
        ("P1 probe (24, 768, 16x64)", q, mask, torch.bfloat16, True),
        ("P1 logits std 40", q * SOFTCLAMP_Q_GAIN, mask, torch.bfloat16,
         False),
        ("P1 element 1 fully masked", q, one_dead, torch.bfloat16, False),
        ("P1 f32", q, mask, torch.float32, False)]
    result = dict(cases={}, max_abs_err=0.0, launches=counts["flash_bnhd"])
    for label, qq, m, dtype, timed in cases:
        qq, kk, vv = (t.to(dtype) for t in (qq, k, v))

        def run(qq=qq, kk=kk, vv=vv, m=m):
            return probe.flash_bnhd(qq, kk, vv, m, softclamp=50.0, heads=h,
                                    dim_head=d)

        def plain(qq=qq, kk=kk, vv=vv, m=m):
            return fa.attention_reference(
                *(fa._heads_view(t, h, d) for t in (qq, kk, vv)), m,
                softclamp=50.0).transpose(1, 2).flatten(2)

        out = run()
        ref = plain(*(t.float() for t in (qq, kk, vv)))
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
        top = ref.abs().max().item()
        tol = (F32_RTOL if dtype == torch.float32 else KERNEL_RTOL) * \
            max(1.0, top)
        err = (out.float() - ref).abs().max().item()
        log(f"  {label}: max|ref| {top:.3f}, max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if err > tol:
            raise RuntimeError(f"{label}: kernel disagrees with plain version")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if not timed:
            continue
        library = flex_softclamp(torch, qq, kk, vv, m, h)
        lib_err = (library().float() - ref).abs().max().item()
        if lib_err > tol:
            raise RuntimeError(f"{label}: library yardstick disagrees with "
                               f"the plain version ({lib_err:.3e})")
        ms = time_ms(torch, run)
        g_ms = graph_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=5)
        lib_ms = device_ms(torch, library)
        bound_ms, bound_by, flops = bound((b, h, n, n, d), 2, m.numel())
        log(f"    kernel {ms:.4f} ms events ({vs_cuda_core(label, ms)}), "
            f"{g_ms:.4f} ms graph ({flops / g_ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms profiler (compiled "
            f"flex_attention, max_abs_err {lib_err:.3e}), bound "
            f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / g_ms:.1%} of "
            f"bound by graph)")
        result["cases"][label] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)
    return result


# --------------------------------------------------------------- phase 4

def phase_small(torch) -> None:
    """A small f32 config whose head dims (64, 104) the kernels take: the
    port on the card against the port on the CPU, same weights and x0: the
    empty-prompt V2A path, then a prompt (T5) and a roll from a few strips
    at strip stride 2 (Video2Roll)."""
    from v2ap_torch import config as C
    from v2ap_torch.models.clip_vit import CLIPVisionConfig
    from v2ap_torch.models.t5 import T5Config
    from v2ap_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    cfg = base.replace(
        model=dataclasses.replace(
            base.model, dim=128, depth=2, heads=2, dim_text=128, text_heads=2,
            text_depth=2, dim_frames=128, frames_heads=2, dim_context=128,
            max_seq_len=256, dtype="float32"),
        conditioning=dataclasses.replace(base.conditioning, frame_stride=1,
                                         feature_cache=False))
    clip = CLIPVisionConfig(hidden_size=208, intermediate_size=416,
                            num_layers=2, num_heads=2, image_size=56,
                            projection_dim=128, dtype="float32")
    t5 = T5Config(vocab_size=1000, d_model=128, d_kv=64, d_ff=256,
                  num_layers=2, num_heads=2, dtype="float32")
    gpu = V2APipeline(cfg, seed=1, device="cuda", clip_config=clip,
                      t5_config=t5, quantize_towers=False)
    cpu = V2APipeline(cfg, seed=1, device="cpu", clip_config=clip,
                      t5_config=t5, quantize_towers=False)
    for a, b in ((gpu.cfm, cpu.cfm), (gpu.codec, cpu.codec),
                 (gpu.clip, cpu.clip), (gpu.t5, cpu.t5)):
        b.load_state_dict(a.state_dict())
    rng = __import__("numpy").random.default_rng(1)
    frames = rng.integers(0, 256, (12, 56, 56, 3), dtype="uint8")
    n, n_valid = 96, 75
    reset_launch_counts()
    feats = [p.encode_video_frames_clip(None, n, frames_cache=[(frames, 1.0, 1)])[0]
             for p in (gpu, cpu)]
    x0 = torch.randn(1, n, 128, generator=torch.Generator().manual_seed(2))
    mask = torch.arange(n)[None] < n_valid
    sampler = C.SamplerConfig(steps=4, cfg_strength=2.0)
    lat, wav = [], []
    with torch.inference_mode():
        for p, f in zip((gpu, cpu), feats):
            dev = p.device
            lat.append(p.cfm.sample(
                x0.to(dev), text_embed=f[None], frames_embed=torch.zeros(
                    1, n, cfg.model.notes, device=dev),
                context=torch.zeros(1, 1, 128, device=dev),
                context_mask=torch.ones(1, 1, dtype=torch.bool, device=dev),
                mask=mask.to(dev), sampler=sampler))
            wav.append(p.codec.decode(lat[-1][:, :n_valid]))
    # a prompt and a roll from 8 strips (0.32 s, 9 Video2Roll windows)
    strips = rng.integers(0, 256, (8, 100, 900), dtype="uint8")
    ctx, roll, lat_p, wav_p = [], [], [], []
    with torch.inference_mode():
        for p, f in zip((gpu, cpu), feats):
            dev = p.device
            c, cm = p.encode_text([PROMPT])
            r = p._roll_from_strips(p._strided_strip_plan(
                strips[::p.strip_stride], len(strips), 0.32, n), n)
            ctx.append(c)
            roll.append(r)
            lat_p.append(p.cfm.sample(
                x0.to(dev), text_embed=f[None], frames_embed=r, context=c,
                context_mask=cm, mask=mask.to(dev), sampler=sampler))
            wav_p.append(p.codec.decode(lat_p[-1][:, :n_valid]))
    torch.cuda.synchronize()
    checks = [("features", feats), ("latents", lat), ("waveform", wav),
              ("prompt context", ctx), ("roll (strip stride 2)", roll),
              ("latents (prompt, roll)", lat_p),
              ("waveform (prompt, roll)", wav_p)]
    for name, (g, c) in checks:
        g = g.cpu()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"small: non-finite {name} on the card")
        err = rel_rms(g, c)
        log(f"  small f32 {name} {tuple(g.shape)}: rel-RMS card vs CPU "
            f"{err:.2e} (tol {SMALL_REL_RMS})")
        if err > SMALL_REL_RMS:
            raise RuntimeError(f"small: {name} disagree")
    if not (launch_counts["flash_attention"] and
            launch_counts["flash_attention_packed"]):
        raise RuntimeError(f"small: kernels not launched: {launch_counts}")


# --------------------------------------------------------------- phase 5

def full_pipeline(torch, label: str, tokenizer_path=None, **conditioning):
    """The shipped configuration, v2a_default(), with ``conditioning``
    changed and no feature caches, from seed 0 on the card, bf16 towers
    (JAX's ``V2AP_INT8_TOWERS=0``), prompts through ``tokenizer_path``'s
    tokenizer when given."""
    from v2ap_torch import config as C
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    cfg = base.replace(conditioning=dataclasses.replace(
        base.conditioning, feature_cache=False, **conditioning))
    t0 = time.perf_counter()
    pipe = V2APipeline(cfg, seed=0, device="cuda", quantize_towers=False,
                       tokenizer_path=tokenizer_path)
    torch.cuda.synchronize()

    def m(module):
        return sum(p.numel() for p in module.parameters()) / 1e6

    v2r = pipe.cfm.video2roll
    log(f"  build full-width {label} pipeline: {time.perf_counter() - t0:.2f} "
        f"s (CFM {m(pipe.cfm) - (m(v2r) if v2r is not None else 0):.1f} M "
        f"params f32 + Video2Roll {m(v2r) if v2r is not None else 0:.1f} M "
        f"f32, ViT-bigG {m(pipe.clip):.1f} M bf16, FLAN-T5 encoder "
        f"{m(pipe.t5):.1f} M bf16, EnCodec {m(pipe.codec):.1f} M "
        f"f32; frame stride {pipe.frame_stride}, strip stride "
        f"{pipe.strip_stride})")
    return pipe


def clip_frames():
    import numpy as np

    return np.random.default_rng(0).integers(
        0, 256, (int(CLIP_S * FPS), 224, 224, 3), dtype=np.uint8)


def generate_expect(pipe, n_frames: int) -> dict:
    """Kernel launches of one 25-step CFG generate that replays its sampler
    program: K2 for the 48 tower layers per chunk of 64 encoded frames, K1
    the replay's (``k1_expect``, which the capture recorded), N1 and N2 the
    replay's (``norm_expect`` of its 24 evaluations: 2040 and 864 for
    v2a_default()), Q1 and Q2 for the towers' int8 products
    (``int8_tower_calls``; none under bf16 towers), nothing else."""
    from v2ap_torch.ops.flash_attention import launch_counts

    encoded = len(range(0, n_frames, pipe.frame_stride))
    expect = dict.fromkeys(launch_counts, 0)
    expect["flash_attention"] = (pipe.clip_cfg.num_layers
                                 * math.ceil(encoded / 64))
    expect["flash_attention_packed"] = k1_expect(pipe)
    expect.update(norm_expect(pipe.cfg.model, 25 - 1))
    expect.update(int8_expect(int8_tower_calls(pipe, n_frames)))
    return expect


def int8_tower_calls(pipe, n_frames: int) -> int:
    """The towers' int8 ``Linear`` products over ``n_frames`` frames: every
    tower runs each of its int8 Linears once a chunk of 64 encoded
    frames."""
    from v2ap_torch.ops.layers import Linear

    encoded = len(range(0, n_frames, pipe.frame_stride))
    return (sum(m.int8 for t in pipe.towers for m in t.model.modules()
                if isinstance(m, Linear)) * math.ceil(encoded / 64))


def int8_expect(calls: int) -> dict:
    """Q1 and Q2 launches of ``calls`` int8 ``Linear`` products: two Q1
    (activations, weight) and one Q2 each."""
    return {"int8_quantize": 2 * calls, "int8_dequantize": calls}


def norm_expect(m, forwards: int) -> dict:
    """N1 and N2 launches of ``forwards`` transformer forwards without
    autograd (each with a context): per audio layer the attention,
    cross-attention and FF norm and gate, two norms per text and frames
    layer, the final norm; 85 and 36 a forward of v2a_default()."""
    audio = m.depth * (3 if m.if_cross_attn else 2)
    return {"rms_norm": forwards * (audio + 2 * m.text_depth + 2 * m.depth
                                    + 1),
            "gated_residual": forwards * audio}


def stage_keys(timings: dict) -> list:
    """The stages' seconds of ``last_timings`` (not its counts or
    ``since_init``)."""
    return [k for k in timings if k.endswith("_s")]


def k1_expect(pipe) -> int:
    """K1 launches in one 25-step CFG sampler run: every attention of the
    (steps - 1) batch-doubled transformer evals."""
    m = pipe.cfg.model
    return (25 - 1) * (m.depth + (m.depth if m.if_cross_attn else 0)
                       + 2 * m.text_depth)


def log_captures(pipe, since: int) -> None:
    """The capture cost and pool memory of every program captured after
    the first ``since`` (warm-up included, once per key)."""
    for key, seconds, warmup_s, pool in pipe.graphs.captures[since:]:
        kind, sampler = key[0], key[1]
        x0_shape = next(d[0] for d in key[2:] if isinstance(d, tuple))
        extra = (f", passes {key[2]}, restart_t {key[3]}"
                 if kind == "multipass" else "")
        log(f"  captured the sampler ({kind}, x0 {x0_shape}, "
            f"{sampler.steps} steps, cfg {sampler.cfg_strength}{extra}): "
            f"{seconds:.3f} s (warm-up {warmup_s:.3f} s), pool "
            f"{pool / 2**20:.1f} MiB")


def phase_generate(torch, pipe, label: str, gen, expect: dict,
                   check=None, runs: int = GENERATE_RUNS) -> dict:
    """One warm-up ``gen()`` (it captures the sampler's program), then
    ``runs`` timed ones. The launch counters are zeroed just before
    each timed run and read just after it; every run must give finite
    audio of the clip's length, the expected counts (the wrappers' and the
    sampler replay's) and pass ``check(pipe)``. Reports and returns the
    median wall time (``wall``, every one in ``walls``) and each stage's
    median (``stages``)."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    since = len(pipe.graphs.captures)
    t0 = time.perf_counter()
    gen()                                         # warm: handles, capture
    torch.cuda.synchronize()
    log(f"  warm-up generate: {time.perf_counter() - t0:.3f} s")
    log_captures(pipe, since)
    torch.cuda.reset_peak_memory_stats()
    walls, stages = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wav, sr = gen()
        walls.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        stages.append(pipe.last_timings)
        if wav.shape != (int(CLIP_S * sr),) or not np.isfinite(wav).all():
            raise RuntimeError(f"{label}: bad waveform {wav.shape}")
        if counts != expect:
            raise RuntimeError(f"{label}: launch counts {counts} != {expect}")
        if check is not None:
            check(pipe)
    wall = float(np.median(walls))
    stage_med = ", ".join(f"{k} {np.median([s[k] for s in stages]):.4f}"
                          for k in stage_keys(stages[0]))
    log(f"  {label} 10 s clip x{runs}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s, "
        f"realtime factor {CLIP_S / wall:.3f}x")
    log(f"  median stages (s): {stage_med}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; waveform "
        f"{wav.shape} finite, rms "
        f"{float(np.sqrt(np.mean(wav.astype(np.float64) ** 2))):.4f}")
    log(f"  launches per run: {counts} (expected {expect}; K1 by the "
        f"sampler program's replay); host syncs per run "
        f"{[s['host_syncs'] for s in stages]}")
    return {"wall": wall, "walls": walls,
            "stages": {k: float(np.median([s[k] for s in stages]))
                       for k in stage_keys(stages[0])}}


def check_roll(pipe) -> None:
    """The roll a V2P generate used: finite, in [0, 1], not all zero."""
    roll = pipe.last_roll
    ok = (roll is not None and roll.isfinite().all().item()
          and 0.0 <= roll.min().item() and roll.max().item() <= 1.0
          and roll.any().item())
    if not ok:
        raise RuntimeError("V2P generate: the roll is missing, non-finite, "
                           "outside [0, 1] or all zero")


# kernel-name fragments -> the group a kernel's time is reported under
PROFILE_GROUPS = (("K2 flash_fwd_sm90 d104", "flash_fwd_sm90_kernel<104>"),
                  ("N1 rms_norm", "rms_norm_kernel"),
                  ("N2 gated_residual", "gated_residual_kernel"),
                  ("Q1 int8 quantize", "quantize_kernel<"),
                  ("Q2 int8 dequantize", "dequantize_vec_kernel",
                   "dequantize_scalar_kernel"),
                  ("K1/K3 flash_fwd_sm90 d64", "flash_fwd_sm90_kernel<64>"),
                  ("flash_fwd f32 (CUDA cores)", "flash_fwd_kernel<"),
                  ("K4 flash_bwd_dq_sm90", "flash_bwd_dq_sm90_kernel<"),
                  ("K5 flash_bwd_dkv_sm90", "flash_bwd_dkv_sm90_kernel<"),
                  ("flash_bwd f32 (CUDA cores)", "flash_bwd_dq_kernel<",
                   "flash_bwd_dkv_kernel<"),
                  # before matmul: cuDNN's implicit-GEMM kernels say "gemm"
                  ("convolution", "conv", "fprop", "dgrad", "wgrad", "cudnn"),
                  ("matmul (cuBLAS)", "nvjet", "gemm", "xmma", "cutlass"),
                  ("optimizer / EMA (foreach)", "multi_tensor_apply"),
                  ("dtype casts / copies", "copy_kernel"),
                  ("LSTM", "lstm", "LSTM", "RNN"))


# the CUDA-core kernels, which run f32 only: a profile of a bf16 run that
# shows one fails
CUDA_CORE = ("flash_fwd_kernel<", "flash_bwd_dq_kernel<",
             "flash_bwd_dkv_kernel<")
SM90_FWD = ("flash_fwd_sm90_kernel<104>", "flash_fwd_sm90_kernel<64>")
SM90_BWD = ("flash_bwd_dq_sm90_kernel<64>", "flash_bwd_dkv_sm90_kernel<64>")


def phase_profile(torch, label: str, run, expect: tuple = (),
                  counts_expect=None, k1_launches=None):
    """CUDA kernel time over one ``run()`` (which raises on a bad result),
    by group and by kernel, and its share of the profiled run's wall time;
    kernels launched from the host (the profiler's cu*/cuda*LaunchKernel*
    calls) against CUDA-graph launches. A failed run or profiler fails the
    run, and so does a profile in which a kernel named in ``expect`` did
    not run or a CUDA-core kernel did (every profiled run is bf16). With
    ``counts_expect`` the launch counters are zeroed just before the run
    and read just after, must equal it, and are returned; their K1 (the
    sampler program's replay) and the count of
    ``flash_fwd_sm90_kernel<64>`` (the only d-64 forward of a generate) in
    the trace must both be ``k1_launches``. A profiler that records no
    device time fails such a run (K1 not seen in a trace), and is reported
    as not measured otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reset_launch_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
    rows = kernel_rows(prof)
    total = sum(e.device_time_total for e in rows)
    if not total:
        if k1_launches is not None:
            raise RuntimeError(f"{label} profile: no device time recorded, "
                               f"K1 launches not counted")
        log("  profile: no device time recorded (not measured)")
        return None
    log(f"  profile: {total / 1e3:.1f} ms CUDA kernel time in one {label} "
        f"of {wall * 1e3:.1f} ms wall under the profiler (kernels busy "
        f"{total / 1e6 / wall:.1%} of it)")
    groups = {}
    for e in rows:
        name = next((g[0] for g in PROFILE_GROUPS
                     if any(s in e.key for s in g[1:])), "other")
        ms, n = groups.get(name, (0.0, 0))
        groups[name] = (ms + e.device_time_total / 1e3, n + e.count)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    group {name:26s} {ms:9.2f} ms {n:7d} launches "
            f"{ms * 1e3 / total:6.1%}")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        log(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.device_time_total / total:6.1%}  {e.key[:90]}")
    api = {e.key: e.count for e in prof.key_averages()
           if "LaunchKernel" in e.key or e.key == "cudaGraphLaunch"}
    host_launches = sum(n for k, n in api.items() if "LaunchKernel" in k)
    log(f"    host-launched kernels {host_launches} "
        f"({', '.join(f'{k} {n}' for k, n in sorted(api.items()))}); "
        f"kernels on the device {sum(e.count for e in rows)}")
    if counts_expect is not None:
        k1 = sum(e.count for e in rows if "flash_fwd_sm90_kernel<64>" in e.key)
        norms = {name: sum(e.count for e in rows if f"{name}_kernel" in e.key)
                 for name in ("rms_norm", "gated_residual")}
        log(f"    launches by the counters {counts} (expected "
            f"{counts_expect}); K1 launches in the trace: {k1} (expected "
            f"{k1_launches}, {api.get('cudaGraphLaunch', 0)} "
            f"cudaGraphLaunch); N1, N2 in the trace: {norms}")
        if counts != counts_expect or k1 != k1_launches \
                or counts["flash_attention_packed"] != k1 \
                or any(counts[name] != n for name, n in norms.items()):
            raise RuntimeError(f"{label} profile: launches {counts}, K1 {k1} "
                               f"and N1, N2 {norms} in the trace; expected "
                               f"{counts_expect}, K1 {k1_launches}")
    missing = [k for k in expect if not any(k in e.key for e in rows)]
    stale = [e.key for e in rows if any(c in e.key for c in CUDA_CORE)]
    if missing or stale:
        raise RuntimeError(f"{label} profile: tensor-core kernels not run "
                           f"({missing}) or CUDA-core ones ran ({stale})")
    log(f"    the tensor-core kernels ran ({', '.join(expect)}); no "
        f"CUDA-core kernel ({', '.join(c + '...>' for c in CUDA_CORE)})")
    return counts


# --------------------------------------------------------------- phases 7-10

def sampler_inputs(torch, pipe, frames):
    """A 10 s clip's sampler inputs at the serving bucket: its CLIP
    features (n 768, 750 valid), x0 from seed 7, a zero roll and an empty
    prompt's zero context, as ``generate`` makes them."""
    m = pipe.cfg.model
    dev = pipe.device
    n, n_valid = 768, 750
    with torch.inference_mode():
        feats, _ = pipe.encode_video_frames_clip(
            None, n, frames_cache=[(frames, CLIP_S, 1)])
    return (pipe._normal(7, (1, n, m.num_channels)), feats[None],
            torch.zeros(1, n, m.notes, device=dev),
            torch.zeros(1, 1, m.dim_context, device=dev),
            torch.ones(1, 1, dtype=torch.bool, device=dev),
            torch.arange(n, device=dev)[None] < n_valid)


def phase_captured(torch, pipe, frames) -> None:
    """The full-width sampler as captured programs (``pipe._sample``,
    ``pipe._sample_multipass``) against ``pipe.cfm`` run eagerly on the
    same x0 and conditioning: the 25-step CFG sampler, the 4-step few-step
    one and two restart passes must give bit-equal latents, from a capture
    and from a replay; each path's wall (synchronised host clock) is
    printed beside the eager one's."""
    from v2ap_torch import config as C

    x0, text, roll, ctx, cmask, mask = sampler_inputs(torch, pipe, frames)
    noises = pipe._normal(8, (1,) + tuple(x0.shape))
    kw = dict(text_embed=text, frames_embed=roll, context=ctx,
              context_mask=cmask, mask=mask)
    cfg25 = C.SamplerConfig(steps=25, cfg_strength=2.0)
    few = C.SamplerConfig(steps=4, cfg_strength=0.0, sway_sampling=False)
    cases = [
        ("CFG, 25 steps", cfg25,
         lambda: pipe._sample(x0, text, roll, ctx, cmask, mask, cfg25),
         lambda: pipe.cfm.sample(x0, sampler=cfg25, **kw)),
        ("few-step, 4 steps, no CFG", few,
         lambda: pipe._sample(x0, text, roll, ctx, cmask, mask, few),
         lambda: pipe.cfm.sample(x0, sampler=few, **kw)),
        ("passes 2, restart_t 0.6", cfg25,
         lambda: pipe._sample_multipass(x0, text, roll, ctx, cmask, mask,
                                        cfg25, noises, 2, 0.6),
         lambda: pipe.cfm.sample_multipass(x0, passes=2, restart_t=0.6,
                                           noises=noises, sampler=cfg25,
                                           **kw))]
    for label, _, captured, eager in cases:
        since = len(pipe.graphs.captures)
        first = captured()                 # a capture, or the V2A key's replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = captured()                 # a replay
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = eager()
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        same = torch.equal(first, want) and torch.equal(again, want)
        diff = (again - want).abs().max().item()
        log_captures(pipe, since)
        log(f"  {label}: captured vs eager bit-equal {same} (max |diff| "
            f"{diff:.3e}); wall captured {t_graph:.4f} s, eager "
            f"{t_eager:.4f} s")
        if not same or not torch.isfinite(want).all():
            raise RuntimeError(f"captured sampler ({label}) differs from the "
                               f"eager one")


def phase_generate_batch(torch, pipe, frames) -> tuple:
    """``generate_batch`` over BATCH 10 s clips handed in decoded (the
    frames rolled in time, one clip each), empty prompts, x0 from the
    seeds the single generates draw: one warm-up (it captures batch
    BATCH), then BATCH_RUNS timed calls (launch counts checked as in the
    generate phase), then each clip's own ``generate``, whose audio each
    batch row must match within BATCH_REL_RMS."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    m = pipe.cfg.model
    clips = [np.roll(frames, 17 * i, axis=0) for i in range(BATCH)]
    caches = [[(c, CLIP_S, 1)] for c in clips]
    seeds = [100 + i for i in range(BATCH)]
    x0 = torch.cat([pipe._normal(s, (1, 768, m.num_channels)) for s in seeds])

    def run():
        return pipe.generate_batch([None] * BATCH, [""] * BATCH,
                                   duration_s=CLIP_S, frames_caches=caches,
                                   x0=x0)

    expect = generate_expect(pipe, len(frames))    # K2 for every clip
    expect["flash_attention"] *= BATCH
    since = len(pipe.graphs.captures)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"  warm-up generate_batch: {time.perf_counter() - t0:.3f} s")
    log_captures(pipe, since)
    walls, stages = [], []
    for _ in range(BATCH_RUNS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wavs, sr = run()
        walls.append(time.perf_counter() - t0)
        stages.append(pipe.last_timings)
        counts = dict(launch_counts)
        if wavs.shape != (BATCH, int(CLIP_S * sr)) \
                or not np.isfinite(wavs).all():
            raise RuntimeError(f"generate_batch: bad waveforms {wavs.shape}")
        if counts != expect:
            raise RuntimeError(f"generate_batch: launch counts {counts} != "
                               f"{expect}")
    wall = float(np.median(walls))
    log(f"  generate_batch {BATCH} x 10 s clips x{BATCH_RUNS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s, "
        f"{BATCH * CLIP_S / wall:.3f} audio-s per wall-s; median stages (s) "
        + ", ".join(f"{k} {np.median([st[k] for st in stages]):.4f}"
                    for k in stage_keys(stages[0]))
        + f"; host syncs {[st['host_syncs'] for st in stages]}")
    log(f"  launches by the wrappers per call: {counts}")
    errs, single_walls = [], []
    for i, s in enumerate(seeds):
        t0 = time.perf_counter()
        wav, _ = pipe.generate(None, seed=s, frames_cache=caches[i])
        single_walls.append(time.perf_counter() - t0)
        errs.append(rel_rms(torch.from_numpy(wavs[i]), torch.from_numpy(wav)))
    log(f"  each clip's own generate: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in single_walls)} (sum "
        f"{sum(single_walls):.4f}); batch row vs its generate rel-RMS "
        f"{', '.join(f'{e:.3e}' for e in errs)} (tol {BATCH_REL_RMS})")
    if max(errs) > BATCH_REL_RMS:
        raise RuntimeError("generate_batch: a row differs from its generate")
    return wall, walls


def phase_generate_long(torch, pipe) -> None:
    """``generate_long`` over a LONG_S clip of seeded 224x224 frames at
    25 fps handed in decoded: chunk_plan's three 10 s chunks (1 s overlap)
    in one batched sampler call (batch 3 runs padded to 4, the program of
    the batch phase); finite audio of the clip's length."""
    import numpy as np

    from v2ap_torch.pipelines.merge import chunk_plan, generate_long

    frames = np.random.default_rng(3).integers(
        0, 256, (int(LONG_S * FPS), 224, 224, 3), dtype=np.uint8)
    plan = chunk_plan(LONG_S)
    since = len(pipe.graphs.captures)
    walls = []
    for _ in range(2):                       # the first captures if new
        t0 = time.perf_counter()
        wav, sr = generate_long(pipe, None, frames_cache=[(frames, LONG_S, 1)])
        walls.append(time.perf_counter() - t0)
        if wav.shape != (int(LONG_S * sr),) or not np.isfinite(wav).all():
            raise RuntimeError(f"generate_long: bad waveform {wav.shape}")
    log_captures(pipe, since)
    log(f"  generate_long {LONG_S:.0f} s clip, {len(plan)} chunks {plan}: "
        f"{wav.shape[0]} samples at {sr} Hz; walls {walls[0]:.4f} s, "
        f"{walls[1]:.4f} s ({LONG_S / walls[1]:.3f}x realtime; "
        f"{len(pipe.graphs.captures) - since} new captures)")
    if len(plan) != 3:
        raise RuntimeError(f"generate_long: plan {plan} is not 3 chunks")


def _multipart(fields: dict, name: str, payload: bytes) -> tuple:
    boundary = "----v2apchipsmoke"
    body = b"".join(
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\""
        f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items())
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             f"name=\"video\"; filename=\"{name}\"\r\nContent-Type: "
             f"video/mp4\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def phase_http(torch, pipe) -> None:
    """The stdlib server (``v2ap_torch.serving.server.serve``) on
    127.0.0.1, port 0, over the full-width pipeline: BATCH concurrent
    ``POST /v2a`` must be answered by ONE ``generate_batch`` call (counted
    by a wrapper here), each a 200 with a WAV of 10 s at 24 kHz; /healthz
    and /metrics must show the requests. The uploads are bytes that no
    decoder reads as a video (this machine has no cv2 to decode one): the
    server then serves the unconditioned route, zero frame features at
    the default 10 s, as the JAX server serves a clip it cannot decode.
    Then ``phase_mixed`` on the same server."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from v2ap_torch.data.audio_io import read_wav
    from v2ap_torch.serving.server import serve

    calls = []
    batch = pipe.generate_batch

    def counted(paths, prompts, **kw):
        calls.append(len(paths))
        return batch(paths, prompts, **kw)

    pipe.generate_batch = counted
    server = serve(pipe, host="127.0.0.1", port=0, block=False,
                   max_batch=BATCH, window_ms=HTTP_WINDOW_MS)
    port = server.server_address[1]
    url = f"http://127.0.0.1:{port}"
    results, errors = {}, []

    def post(i):
        body, ctype = _multipart({"prompt": "", "steps": "25"},
                                 f"clip{i}.mp4", bytes(range(256)) * 64)
        req = urllib.request.Request(f"{url}/v2a", data=body, method="POST",
                                     headers={"Content-Type": ctype})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, r.headers["Content-Type"], r.read(),
                              time.perf_counter() - t0)
        except Exception as exc:             # reported below, fails the run
            errors.append(f"request {i}: {exc!r}")

    def wave(ids):
        """POST the requests ``ids`` at once and wait for every answer."""
        threads = [threading.Thread(target=post, args=(i,)) for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(i not in results for i in ids):
            raise RuntimeError(f"http: {errors or 'requests unanswered'}")

    try:
        wave(range(BATCH))
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        first_calls = list(calls)
        phase_mixed(pipe, server, wave, results, calls)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        del pipe.generate_batch               # the pipeline's own again
    shapes = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (status, ctype, data, _) in sorted(results.items()):
            path = os.path.join(tmp, f"{i}.wav")
            with open(path, "wb") as f:
                f.write(data)
            audio, sr = read_wav(path)
            shapes.append((status, ctype, audio.shape, sr,
                           bool(np.isfinite(audio).all())))
    log(f"  {BATCH} concurrent POST /v2a (unconditioned route: the uploads "
        f"do not decode here, as the JAX server serves a clip it cannot "
        f"decode): generate_batch calls {first_calls}; latency (s) "
        + ", ".join(f"{results[i][3]:.4f}" for i in range(BATCH))
        + f"; answers of all {len(shapes)} requests {sorted(set(shapes))}")
    log(f"  /healthz {health}; /metrics {metrics}")
    if first_calls != [BATCH]:
        raise RuntimeError(f"http: {BATCH} requests made generate_batch "
                           f"calls {first_calls}, not one of {BATCH}")
    if any(sh != (200, "audio/wav", (1, int(CLIP_S * 24_000)), 24_000, True)
           for sh in shapes):
        raise RuntimeError(f"http: bad answers {shapes}")
    if health.get("status") != "ok" or metrics.get("v2a", {}).get(
            "requests") != BATCH or metrics["v2a"]["errors"]:
        raise RuntimeError(f"http: healthz {health} / metrics {metrics}")


def phase_mixed(pipe, server, wave, results, calls) -> None:
    """Mixed traffic on the running server: waves of MIXED_WAVES concurrent
    POSTs (each wave one ``generate_batch`` call of its size, the batch
    run padded to a power of two), then one request at each of
    MIXED_DURATIONS handed to the server's batcher as the server hands it
    a decoded clip's duration (the uploads do not decode here). Every
    request must be answered with finite audio of its length; no key may be
    captured twice (a recapture: the program was evicted) and the programs
    must fit MAX_PROGRAMS. Prints each wave's latencies and each new
    capture's cost and pool memory."""
    import numpy as np

    from v2ap_torch.utils.jitting import MAX_PROGRAMS

    since = len(pipe.graphs.captures)
    start = BATCH
    for size in MIXED_WAVES:
        ids = range(start, start + size)
        before = len(calls)
        t0 = time.perf_counter()
        wave(ids)
        log(f"  wave of {size} POSTs (a wave under {BATCH} waits out the "
            f"{HTTP_WINDOW_MS:.0f} ms window): generate_batch calls "
            f"{calls[before:]}, latency (s) "
            + ", ".join(f"{results[i][3]:.4f}" for i in ids)
            + f", wave {time.perf_counter() - t0:.4f} s")
        if calls[before:] != [size]:
            raise RuntimeError(f"mixed: a wave of {size} made calls "
                               f"{calls[before:]}")
        start += size
    for dur in MIXED_DURATIONS:
        t0 = time.perf_counter()
        wav, sr = server.batcher.submit(None, "", duration_s=dur).result(
            timeout=600)
        log(f"  {dur:.0f} s request through the batcher: "
            f"{time.perf_counter() - t0:.4f} s")
        if wav.shape != (int(dur * sr),) or not np.isfinite(wav).all():
            raise RuntimeError(f"mixed: a {dur} s request gave {wav.shape}")
    log_captures(pipe, since)
    keys = [c.key for c in pipe.graphs.captures]
    recaptured = len(keys) - len(set(keys))
    log(f"  mixed traffic: {len(keys) - since} new captures, {recaptured} "
        f"recaptures; {len(pipe.graphs)} programs kept (at most "
        f"{MAX_PROGRAMS}), pools "
        f"{sum(c.pool_bytes for c in pipe.graphs.captures) / 2**30:.2f} GiB "
        f"captured in all")
    if recaptured or len(pipe.graphs) > MAX_PROGRAMS:
        raise RuntimeError(f"mixed: {recaptured} recaptures, "
                           f"{len(pipe.graphs)} programs")


# --------------------------------------------------------------- phase 2b

def flex_grad_calls(torch, qh, kh, vh, mask, dout):
    """K3's and K4 + K5's functions as PyTorch calls, yardsticks only:
    compiled ``flex_attention`` with softclamp 50 and the mask as an f32
    bias in its score_mod, forward returning lse, and its backward for
    (dq, dk, dv). Returns (forward, backward) or None where this torch
    lacks flex_attention."""
    try:
        from torch.nn.attention import flex_attention as flex_mod
    except ImportError:
        return None
    from v2ap_torch.ops.flash_attention import NEG_INF

    flex = torch.compile(flex_mod.flex_attention, dynamic=False)
    bias = torch.where(mask, 0.0, NEG_INF).float()
    aux = ({"return_aux": flex_mod.AuxRequest(lse=True)}
           if hasattr(flex_mod, "AuxRequest") else {"return_lse": True})

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / 50.0) * 50.0 + bias[b, ki]

    def forward():
        with torch.no_grad():
            out, lse = flex(qh, kh, vh, score_mod=score_mod,
                            scale=64 ** -0.5, **aux)
        return out, getattr(lse, "lse", lse)

    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    out = flex(*leaves, score_mod=score_mod, scale=64 ** -0.5)

    def backward():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return forward, backward


def grad_bounds(b, h, nq, nk, d, mask_bytes):
    """(K3, K4, K5) least times: FLOP at the bf16 rate or bytes at the HBM
    rate, whichever is larger. K3 does 4 bhnq nk d FLOP; the backward's
    10 bhnq nk d (five products) split as K4 s, dp, dq (6) and K5 dv,
    dk (4). Bytes: each kernel's bf16 inputs and outputs once, lse and D
    as f32 rows, the mask."""
    qb, kb = 2 * b * h * nq * d, 2 * b * h * nk * d
    rows = 4 * b * h * nq
    work = {"K3": (4.0, qb + 2 * kb + qb + rows + mask_bytes),
            "K4": (6.0, qb + 2 * kb + qb + 2 * rows + mask_bytes + qb),
            "K5": (4.0, qb + 2 * kb + qb + 2 * rows + mask_bytes + 2 * kb)}
    out = {}
    for kid, (f, nbytes) in work.items():
        t_ops = f * b * h * nq * nk * d / BF16_FLOP_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[kid] = (max(t_ops, t_bytes) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_train_kernels(torch) -> dict:
    """K3, K4 and K5 at the training shapes, each against its plain version
    on the same inputs (the backward's lse and D from K3's output, as the
    train step computes them); K4 and K5 also against a second call of
    themselves, which must be bit-equal."""
    from v2ap_torch.ops import flash_attention as fa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    n = TRAIN_LATENTS + 32
    b = TRAIN_BATCH

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    full = torch.ones(b, n, dtype=torch.bool, device=dev)
    ctx_len = torch.randint(4, TRAIN_CONTEXT + 1, (b,), generator=gen,
                            device=dev)
    ctx_mask = torch.arange(TRAIN_CONTEXT, device=dev)[None] < ctx_len[:, None]
    one_dead = torch.ones(2, n, dtype=torch.bool, device=dev)
    one_dead[1] = False
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [   # label, batch, heads, nk, mask, logit gain, dtype, timed
        ("self-attn (8, 782, 16x64)", b, 16, n, full, 1.0, bf16, True),
        ("roll self-attn (8, 782, 8x64)", b, 8, n, full, 1.0, bf16, True),
        ("cross-attn (8, 782x16, 16x64), context 4-16 valid", b, 16,
         TRAIN_CONTEXT, ctx_mask, 1.0, bf16, True),
        ("self-attn, logits std 40 (8, 782, 16x64)", b, 16, n, full,
         SOFTCLAMP_Q_GAIN, bf16, False),
        ("element 1 fully masked (2, 782, 16x64)", 2, 16, n, one_dead, 1.0,
         bf16, False),
        ("f32 self-attn (2, 782, 16x64)", 2, 16, n, full[:2], 1.0, f32,
         False),
    ]
    results = {}
    for label, bb, h, nk, mask, gain, dtype, timed in cases:
        hd = h * 64
        q = rnd(bb, n, hd, dtype=dtype) * gain
        if nk == n:                         # fused qkv chunks, as the model
            qkv = rnd(bb, n, 3 * hd, dtype=dtype)
            qkv[..., :hd] = q
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            k, v = rnd(bb, nk, 2 * hd, dtype=dtype).chunk(2, dim=-1)
        qh, kh, vh = (fa._heads_view(t, h, 64) for t in (q, k, v))
        doh = fa._heads_view(rnd(bb, n, hd, dtype=dtype), h, 64)
        kw = dict(softclamp=50.0)
        out, lse = fa.attention_fwd_lse(qh, kh, vh, mask, **kw)
        delta = (doh.float() * out.float()).sum(-1)
        args = (qh, kh, vh, mask, lse, delta, doh)
        dq = fa.attention_bwd_dq(*args, **kw)
        dk, dv = fa.attention_bwd_dkv(*args, **kw)
        # no atomics, sums in a fixed order: a second call is bit-equal
        again = (fa.attention_bwd_dq(*args, **kw),
                 *fa.attention_bwd_dkv(*args, **kw))
        ref_out, ref_lse = fa.attention_fwd_lse_reference(
            qh.float(), kh.float(), vh.float(), mask, **kw)
        ref = fa.attention_bwd_reference(
            qh.float(), kh.float(), vh.float(), mask, lse, delta,
            doh.float(), **kw)
        torch.cuda.synchronize()
        rtol = F32_RTOL if dtype == f32 else KERNEL_RTOL
        errs = {}
        for kid, got, want in (("K3", (out,), (ref_out,)),
                               ("K4", (dq,), ref[:1]),
                               ("K5", (dk, dv), ref[1:])):
            err, tol, top = 0.0, 0.0, 0.0
            for g, w in zip(got, want):
                if not torch.isfinite(g).all():
                    raise RuntimeError(f"{kid} {label}: non-finite output")
                top = max(top, w.abs().max().item())
                err = max(err, (g.float() - w).abs().max().item())
            tol = rtol * max(1.0, top)
            errs[kid] = (err, tol, top)
        dead_rows = ref_lse < -1e29
        lse_err = (lse - ref_lse).masked_fill(dead_rows, 0).abs().max().item()
        if not bool((lse[dead_rows] < -1e29).all()) or lse_err > LSE_ATOL:
            raise RuntimeError(f"K3 {label}: lse disagrees ({lse_err:.3e})")
        dead = ~mask.any(dim=1)             # batch elements attending nothing
        zero_ok = not any(t[dead].any().item() for t in (dq, dk, dv))
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        log(f"  {label}: " + "; ".join(
            f"{kid} max|ref| {top:.3f} max_abs_err {err:.3e} (tol {tol:.3e})"
            for kid, (err, tol, top) in errs.items())
            + f"; lse max_abs_err {lse_err:.3e}"
            + (f"; fully masked element's grads exactly 0: {zero_ok}"
               if dead.any() else "")
            + f"; K4/K5 bit-equal on a second call: {same}")
        for kid, (err, tol, _) in errs.items():
            if err > tol:
                raise RuntimeError(f"{kid} {label}: kernel disagrees with "
                                   f"its plain version")
        if not zero_ok:
            raise RuntimeError(f"{label}: a fully masked element got a "
                               f"nonzero gradient")
        if not same:
            raise RuntimeError(f"{label}: K4/K5 differ between two calls")
        for kid, (err, _, _) in errs.items():
            entry = results.setdefault(kid, dict(cases={}, max_abs_err=0.0))
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if not timed:
            continue
        calls = {"K3": lambda: fa.attention_fwd_lse(qh, kh, vh, mask, **kw),
                 "K4": lambda: fa.attention_bwd_dq(*args, **kw),
                 "K5": lambda: fa.attention_bwd_dkv(*args, **kw)}
        events = {kid: time_ms(torch, fn) for kid, fn in calls.items()}
        graphs = {kid: graph_ms(torch, fn) for kid, fn in calls.items()}
        plain_fwd = time_ms(torch, lambda: fa.attention_fwd_lse_reference(
            qh, kh, vh, mask, **kw), iters=5)
        plain_bwd = time_ms(torch, lambda: fa.attention_bwd_reference(
            *args, **kw), iters=5)
        lib = flex_grad_calls(torch, qh, kh, vh, mask, doh)
        lib_fwd = lib_bwd = None
        if lib is not None:
            lib_out, lib_lse = lib[0]()
            lib_grads = lib[1]()
            lib_err = max((lib_out.float() - ref_out).abs().max().item(),
                          *((g.float() - r).abs().max().item()
                            for g, r in zip(lib_grads, ref)))
            lib_lse_err = (lib_lse - ref_lse).abs().max().item()
            log(f"    library (flex_attention) max_abs_err {lib_err:.3e}, "
                f"lse {lib_lse_err:.3e}")
            if lib_err > 4 * max(e[1] for e in errs.values()) \
                    or lib_lse_err > 1e-2:
                raise RuntimeError(f"{label}: library yardstick disagrees "
                                   f"with the plain version")
            lib_fwd = device_ms(torch, lib[0])
            lib_bwd = device_ms(torch, lib[1])
        bounds = grad_bounds(bb, h, n, nk, 64, mask.numel())
        times = {"K3": (plain_fwd, lib_fwd), "K4": (plain_bwd, lib_bwd),
                 "K5": (plain_bwd, lib_bwd)}
        for kid, (plain_ms, lib_ms) in times.items():
            bound_ms, bound_by = bounds[kid]
            ms, g_ms = events[kid], graphs[kid]
            results[kid]["cases"][label] = dict(
                ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            log(f"    {kid}: kernel {ms:.4f} ms events "
                f"({vs_cuda_core(f'{kid} {label}', ms)}), {g_ms:.4f} ms "
                f"graph, plain {plain_ms:.4f} ms "
                f"(K4/K5: the whole plain backward), library "
                + ("n/a" if lib_ms is None else f"{lib_ms:.4f} ms profiler"
                   + (" (flex backward: dq, dk, dv together)"
                      if kid != "K3" else ""))
                + f", bound {bound_ms:.4f} ms by {bound_by} "
                f"({bound_ms / g_ms:.1%} of bound by graph)")
    return results


def log_bwd_more(torch) -> None:
    """K4 and K5 where no path trains today: d = 104 at ViT-bigG's (64, 257,
    16x104), against the plain backward, and by graph replay with softclamp
    50 and without; and the training shape without softclamp (graph only),
    which shows what the softclamp's multi-function-unit work costs."""
    from v2ap_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def heads(b, n, h, d):                  # (b, h, n, d) views of (b, n, h, d)
        return torch.randn(b, n, h, d, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    for (b, n, h, d), clamps, check in (((64, 257, 16, 104), (50.0, None), True),
                                        ((TRAIN_BATCH, TRAIN_LATENTS + 32, 16,
                                          64), (None,), False)):
        q, k, v, do = (heads(b, n, h, d) for _ in range(4))
        for clamp in clamps:
            kw = dict(softclamp=clamp)
            out, lse = fa.attention_fwd_lse(q, k, v, None, **kw)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, None, lse, delta, do)
            note = ""
            if check:
                got = (fa.attention_bwd_dq(*args, **kw),
                       *fa.attention_bwd_dkv(*args, **kw))
                ref = fa.attention_bwd_reference(
                    q.float(), k.float(), v.float(), None, lse, delta,
                    do.float(), **kw)
                for kid, g, w in zip(("K4 dq", "K5 dk", "K5 dv"), got, ref):
                    tol = KERNEL_RTOL * max(1.0, w.abs().max().item())
                    err = (g.float() - w).abs().max().item()
                    if not err <= tol:
                        raise RuntimeError(f"{kid} ({b}, {n}, {h}x{d}) "
                                           f"softclamp {clamp}: {err:.3e} > "
                                           f"tol {tol:.3e}")
                    note += f"; {kid} max_abs_err {err:.3e} (tol {tol:.3e})"
                del got, ref
            dq_ms = graph_ms(torch, lambda: fa.attention_bwd_dq(*args, **kw))
            dkv_ms = graph_ms(torch, lambda: fa.attention_bwd_dkv(*args, **kw))
            log(f"  K4/K5 ({b}, {n}, {h}x{d}) softclamp {clamp}: "
                f"{dq_ms:.4f} / {dkv_ms:.4f} ms graph{note}")


# --------------------------------------------------------------- phase 6

def tiny_batch(torch, cfg, b: int = 4, n: int = 96, nc: int = 8):
    """The tiny training batch from numpy seed 0, ragged lens and context."""
    import numpy as np

    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"latents": r(b, n, cfg.num_channels),
            "lens": torch.tensor([n, n - 6, n - 16, n])[:b],
            "text_embed": r(b, n, cfg.dim_text),
            "context": r(b, nc, cfg.dim_context),
            "context_mask": torch.arange(nc)[None] < torch.tensor(
                [[nc], [nc - 3], [2], [nc]])[:b]}


def phase_small_train(torch) -> None:
    """tiny_test() (f32, dropout 0): one train step on the card and on the
    CPU from the same weights and the same draws (made on the CPU); then
    TINY_STEPS steps on the card, whose loss must fall."""
    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM, draw_loss_randoms
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.training import Trainer

    base = C.tiny_test()
    mcfg = dataclasses.replace(base.model, dropout=0.0)
    tcfg = C.TrainConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=1000)
    gpu = CFM(mcfg, base.conditioning, device="cuda")
    cpu = CFM(mcfg, base.conditioning, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    before = {k: v.detach().cpu().clone() for k, v in gpu.named_parameters()}
    batch = tiny_batch(torch, mcfg)
    b, n, c = batch["latents"].shape
    draws = draw_loss_randoms(b, n, c, base.conditioning.frac_lengths_mask,
                              generator=torch.Generator().manual_seed(7))
    results = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        trainer = Trainer(model, tcfg)
        dev = next(model.parameters()).device
        reset_launch_counts()
        loss, _ = trainer.train_step(batch, draws=draws._replace(
            **{f: getattr(draws, f).to(dev) for f in draws._fields}))
        results[name] = (loss.item(), trainer.last_grad_norm.item(),
                         {k: (p.grad.cpu(), p.detach().cpu())
                          for k, p in model.named_parameters()},
                         dict(launch_counts))
    (lg, ng, pg, counts), (lc, nc_, pc, _) = results["card"], results["cpu"]
    per_step = 4 * mcfg.depth
    for k in ("flash_attention_lse", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        if counts[k] != per_step:
            raise RuntimeError(f"small train: {k} launched {counts[k]} "
                               f"times, expected {per_step}")
    loss_err = abs(lg - lc) / abs(lc)
    grad_err = max(rel_rms(pg[k][0], pc[k][0]) for k in pc)
    moved = torch.cat([(pg[k][1] - before[k]).flatten() for k in pc])
    moved_cpu = torch.cat([(pc[k][1] - before[k]).flatten() for k in pc])
    param_err = rel_rms(torch.cat([pg[k][1].flatten() for k in pc]),
                        torch.cat([pc[k][1].flatten() for k in pc]))
    log(f"  tiny_test f32 train step, card vs CPU: loss {lg:.6f} vs {lc:.6f} "
        f"(rel {loss_err:.2e}), grad norm {ng:.5f} vs {nc_:.5f}, worst "
        f"parameter gradient rel-RMS {grad_err:.2e} (tol {SMALL_REL_RMS}), "
        f"updated parameters rel-RMS {param_err:.2e} (tol "
        f"{SMALL_PARAM_REL_RMS}), update rel-RMS "
        f"{rel_rms(moved, moved_cpu):.2e}; launches {counts}")
    if not (loss_err < SMALL_REL_RMS and grad_err < SMALL_REL_RMS
            and param_err < SMALL_PARAM_REL_RMS):
        raise RuntimeError("small train: card and CPU disagree")

    model = CFM(mcfg, base.conditioning, device="cuda")
    trainer = Trainer(model, tcfg)
    gpu_draws = draws._replace(**{f: getattr(draws, f).cuda()
                                  for f in draws._fields})
    losses = []
    t0 = time.perf_counter()
    for _ in range(TINY_STEPS):
        loss, _ = trainer.train_step(batch, draws=gpu_draws)
        losses.append(loss.item())
    log(f"  tiny_test {TINY_STEPS} steps on the card (lr 1e-3, warmup 2): "
        f"first {losses[0]:.4f} last {losses[-1]:.4f} min {min(losses):.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not losses[-1] < losses[0]:
        raise RuntimeError("small train: the loss did not fall")

    reset_launch_counts()
    loss, _, pred = trainer.eval_step(batch, draws=gpu_draws, return_pred=True)
    counts = dict(launch_counts)
    expect = dict.fromkeys(counts, 0)
    expect["flash_attention_packed"] = per_step     # no grad: K1, not K3
    expect.update(norm_expect(mcfg, 1))             # and N1, N2
    log(f"  eval step (times 0.5, no dropout, no grad): loss "
        f"{loss.item():.4f}, pred {tuple(pred.shape)}; launches {counts}")
    if counts != expect or not (torch.isfinite(loss)
                                and torch.isfinite(pred).all()):
        raise RuntimeError(f"small train: eval step launches {counts} != "
                           f"{expect} or non-finite result")


# --------------------------------------------------------------- phase 7

def full_trainer(torch, cfg=None, train_cfg=None, pair: bool = False):
    """A full-width CFM (``cfg``, v2a_default() by default: bf16 compute,
    f32 params, dropout 0.1) from seed 0 on the card, a Trainer with
    ``train_cfg`` (TrainConfig() with EMA by default), and the synthetic
    batch; ``pair`` gives rows 6 and 7 the same conditioning (a preference
    pair: a winner and a loser)."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.training import Trainer
    from v2ap_torch.utils.device import seeded_init

    cfg = cfg or C.v2a_default()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with seeded_init(0, dev):
        model = CFM(cfg.model, cfg.conditioning, device=dev)
    trainer = Trainer(model, train_cfg or C.TrainConfig(use_ema=True))
    batch = train_batch(torch, cfg, pair)
    b, n, nc = TRAIN_BATCH, TRAIN_LATENTS, TRAIN_CONTEXT
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.2f} s, CFM "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M f32 "
        f"params, batch {b} x {n} latents (+32 registers), context {nc} "
        f"with {batch['context_mask'].sum(1).tolist()} valid")
    return trainer, batch


def train_batch(torch, cfg, pair: bool = False, dev="cuda") -> dict:
    """The synthetic full-width batch from seed 0 (TRAIN_BATCH x
    TRAIN_LATENTS latents, a context of TRAIN_CONTEXT with 4-16 valid);
    ``pair`` gives rows 6 and 7 the same conditioning."""
    import numpy as np

    rng = np.random.default_rng(0)
    b, n, nc = TRAIN_BATCH, TRAIN_LATENTS, TRAIN_CONTEXT
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    batch = {"latents": r(b, n, cfg.model.num_channels),
             "lens": torch.full((b,), n),
             "text_embed": r(b, n, cfg.model.dim_text),
             "context": r(b, nc, cfg.model.dim_context),
             "context_mask": torch.arange(nc)[None] < torch.from_numpy(
                 rng.integers(4, nc + 1, size=(b, 1)))}
    if pair:
        for k in ("text_embed", "context", "context_mask"):
            batch[k][7] = batch[k][6]
    return {k: v.to(dev) for k, v in batch.items()}


def phase_train(torch, trainer, batch) -> dict:
    """One warm-up step, then TRAIN_STEPS timed ones; counts per step."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    model = trainer.model
    watch = ["to_pred.weight", "transformer.registers",
             "transformer.audio_blocks.0.attn.to_qkv.weight"]
    params = dict(model.named_parameters())
    start = {k: params[k].detach().clone() for k in watch}
    ema_start = {k: trainer.ema.shadow[k].clone() for k in watch}
    expect = dict.fromkeys(launch_counts, 0)
    per_step = model.cfg.depth * 4        # 3 self-attentions + 1 cross
    expect.update(flash_attention_lse=per_step,
                  flash_attention_bwd_dq=per_step,
                  flash_attention_bwd_dkv=per_step)
    t0 = time.perf_counter()
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.perf_counter() - t0:.3f} s, loss "
        f"{loss.item():.4f}")
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        losses.append(loss.item())
        norms.append(trainer.last_grad_norm.item())
        if counts != expect:
            raise RuntimeError(f"train: launch counts {counts} != {expect}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise RuntimeError(f"train: non-finite loss {losses} or grad norm "
                           f"{norms}")
    moved = {k: (params[k] - start[k]).abs().max().item() for k in watch}
    ema_moved = {k: (trainer.ema.shadow[k] - ema_start[k]).abs().max().item()
                 for k in watch}
    if not (all(moved.values()) and all(ema_moved.values())):
        raise RuntimeError(f"train: parameters {moved} or EMA {ema_moved} "
                           f"did not move")
    wall = float(np.median(walls))
    audio_s = TRAIN_BATCH * TRAIN_LATENTS / 75.0
    log(f"  train step x{TRAIN_STEPS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s, "
        f"{audio_s / wall:.2f} training audio-s per s ({audio_s:.0f} s of "
        f"audio per step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in norms)}; max |param change| "
        f"{max(moved.values()):.3e}, max |EMA change| "
        f"{max(ema_moved.values()):.3e}")
    log(f"  launches per step: {counts}")
    return counts


def phase_train_remat(torch, trainer, batch, plain_counts: dict) -> None:
    """The same trainer and batch with ``ModelConfig.remat`` on, per policy
    ("full", "dots"): one warm-up step, one timed step (wall, peak memory,
    launches) and one under the profiler (kernel time, busy share,
    host-launched kernels). Each attention runs again in its layer's
    recompute, so K3 must launch twice its count without remat; K4 and K5
    as often as without."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    model = trainer.model
    base = model.cfg
    expect = dict(plain_counts)
    expect["flash_attention_lse"] *= 2
    try:
        for policy in ("full", "dots"):
            model.cfg = model.transformer.cfg = dataclasses.replace(
                base, remat=True, remat_policy=policy)
            trainer.train_step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(launch_counts)
            peak = torch.cuda.max_memory_allocated()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            kernels = sum(e.device_time_total for e in kernel_rows(prof))
            host = sum(e.count for e in prof.key_averages()
                       if "LaunchKernel" in e.key)
            log(f"  remat {policy}: step {wall:.4f} s (after one warm-up), "
                f"peak memory {peak / 2**30:.2f} GiB, loss {loss.item():.4f}; "
                f"launches {counts}; profiled step: {kernels / 1e3:.1f} ms "
                f"of kernels in {prof_wall * 1e3:.1f} ms (busy "
                f"{kernels / 1e6 / prof_wall:.1%}), {host} host-launched "
                f"kernels")
            if counts != expect or not np.isfinite(loss.item()):
                raise RuntimeError(f"train remat {policy}: launches {counts} "
                                   f"!= {expect} or non-finite loss")
    finally:
        model.cfg = model.transformer.cfg = base


# --------------------------------------------------------------- phase 16

def make_corpus(root: str) -> list:
    """The seeded corpus under ``root``, in the default corpora's layout:
    CORPUS_WAVS 10 s 24 kHz wavs in each of ``audioset_sl.scp`` and
    ``bbc.scp`` (the sound effects), two rows of ``vggsound_train.scp`` and
    one of ``piano_train.scp``, whose .mp4 paths do not exist: each has its
    sibling .wav, the piano row its 88-key ``.3.npy`` roll at the latent
    rate. Returns the video paths."""
    import numpy as np

    from v2ap_torch.data.audio_io import SAMPLE_RATE, write_wav

    rng = np.random.default_rng(2)
    n = int(CLIP_S * SAMPLE_RATE)

    def wav(stem):
        path = os.path.join(root, stem + ".wav")
        write_wav(path, (rng.normal(size=n) * rng.uniform(0.05, 0.2)
                         ).astype(np.float32))
        return path

    manifests = {
        "audioset_sl.scp": [(wav(f"a{i}"), f"Sound {i}")
                            for i in range(CORPUS_WAVS)],
        "bbc.scp": [(wav(f"e{i}"), f"Effect {i}") for i in range(CORPUS_WAVS)],
        "vggsound_train.scp": [], "piano_train.scp": []}
    videos = []
    for scp, stem, caption in (("vggsound_train.scp", "v0", "a dog barks"),
                               ("vggsound_train.scp", "v1", "rain"),
                               ("piano_train.scp", "p0", "a piano")):
        wav(stem)
        path = os.path.join(root, stem + ".mp4")
        manifests[scp].append((path, caption))
        videos.append(path)
    np.save(os.path.join(root, "p0.3.npy"),
            (rng.random((TRAIN_LATENTS, 88)) > 0.9).astype(np.float32))
    for scp, rows in manifests.items():
        with open(os.path.join(root, scp), "w") as f:
            f.writelines(f"{p}\t{c}\n" for p, c in rows)
    return videos


def corpus_config():
    """v2a_default() as the CLI trains it: remat "dots", TrainConfig
    defaults with EMA and a checkpoint every CORPUS_SAVE_STEP steps."""
    from v2ap_torch import config as C

    cfg = C.v2a_default()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, remat=True, remat_policy="dots"),
        train=dataclasses.replace(cfg.train, use_ema=True,
                                  save_step=CORPUS_SAVE_STEP))


def prime_caches(pipe, videos: list) -> None:
    """What a machine without cv2 needs: each video's tower features and the
    piano video's keyboard strips written to the caches beside the (absent)
    video from seeded decoded frames and strips, through the pipeline's own
    ``frames_cache`` / ``strips_cache``."""
    import numpy as np

    rng = np.random.default_rng(3)
    t = int(CLIP_S * FPS)
    for path in videos:
        frames = rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8)
        pipe.encode_video_frames_clip(path, TRAIN_LATENTS,
                                      frames_cache=[(frames, CLIP_S, 1)])
        if os.path.basename(path).startswith("p"):
            strips = rng.integers(0, 256, (t, 100, 900), dtype=np.uint8)
            pipe.encode_piano_frames(path, TRAIN_LATENTS,
                                     strips_cache=[(strips, CLIP_S)])


def phase_corpus_train(torch, root: str, device: str = "cuda") -> tuple:
    """``TrainingPipeline(v2a_default())`` with the full towers, remat
    "dots" and EMA on the seeded corpus: ``fit`` for one warm-up step and
    CORPUS_STEPS timed ones (batch TRAIN_BATCH x 750 latents), checkpoints
    at CORPUS_SAVE_STEP and its multiples (one kept). Each step's
    ``device_batch`` (EnCodec encode, T5, cache reads) and train step are
    timed apart; launches are counted per step and every flash backward's
    kernel route recorded. Returns (the pipeline, the batcher)."""
    import numpy as np

    from v2ap_torch.data.dataset import TrainBatcher
    from v2ap_torch.data.manifests import default_corpora, load_corpora
    from v2ap_torch.ops import flash_attention as fa
    from v2ap_torch.training.pipeline import TrainingPipeline

    videos = make_corpus(root)
    cfg = corpus_config()
    t0 = time.perf_counter()
    tp = TrainingPipeline(cfg, seed=0, work_dir=os.path.join(root, "run"),
                          device=device)
    tp.resumer.mgr.max_to_keep = 1
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.2f} s (CFM f32 trainable with "
        f"Video2Roll, ViT-bigG and FLAN-T5 bf16, EnCodec f32); free disk "
        f"under the work dir {shutil.disk_usage(root).free / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    prime_caches(tp.pipe, videos)
    log(f"  caches primed for {len(videos)} videos in "
        f"{time.perf_counter() - t0:.2f} s")
    samples = load_corpora(default_corpora(root))
    batcher = TrainBatcher(samples, cfg.data, batch_size=TRAIN_BATCH, seed=0)

    rec = {"db": [], "step": [], "counts": [], "loss": [], "frames": [],
           "saves": [], "routes": {}}
    device_batch, train_step = tp.device_batch, tp.trainer.train_step
    maybe_save, bwd_plan = tp.resumer.maybe_save, fa.bwd_launch_plan

    def timed_batch(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = device_batch(batch)
        torch.cuda.synchronize()
        rec["db"].append(time.perf_counter() - t0)
        for i, vp in enumerate(batch.video_paths):
            if vp is not None and not out["text_embed"][i].any():
                raise RuntimeError(f"corpus train: no CLIP features for {vp}")
            if vp is not None and batch.piano[i] and not (
                    "frames" in out and out["frames"][i].any()):
                raise RuntimeError(f"corpus train: no strips for {vp}")
        rec["frames"].append("frames" in out)
        return out

    def timed_step(batch, **kw):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, bk = train_step(batch, **kw)
        torch.cuda.synchronize()
        rec["step"].append(time.perf_counter() - t0)
        rec["counts"].append(dict(fa.launch_counts))
        rec["loss"].append((loss.item(), float(bk.flow), float(bk.midi)))
        if len(rec["step"]) == 1:            # the timed steps' peak from here
            torch.cuda.reset_peak_memory_stats()
        return loss, bk

    def timed_save():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = maybe_save()
        if saved:
            step = tp.trainer.step
            path = tp.resumer.mgr.path(step)
            rec["saves"].append((step, time.perf_counter() - t0,
                                 os.path.getsize(path)))
        return saved

    def recorded_plan(q, k, v, dout, grads):
        plan = bwd_plan(q, k, v, dout, grads)
        rec["routes"][plan.route] = rec["routes"].get(plan.route, 0) + 1
        return plan

    tp.device_batch, tp.trainer.train_step = timed_batch, timed_step
    tp.resumer.maybe_save = timed_save
    fa.bwd_launch_plan = recorded_plan
    try:
        final = tp.fit(batcher, num_steps=1 + CORPUS_STEPS, log_every=1)
        peak = torch.cuda.max_memory_allocated()
    finally:
        fa.bwd_launch_plan = bwd_plan
        del tp.device_batch, tp.trainer.train_step, tp.resumer.maybe_save
    for i, ((loss, flow, midi), fr, c) in enumerate(
            zip(rec["loss"], rec["frames"], rec["counts"]), 1):
        log(f"  step {i}: device_batch {rec['db'][i - 1]:.4f} s, train step "
            f"{rec['step'][i - 1]:.4f} s; loss {loss:.4f} flow {flow:.4f} "
            f"midi {midi:.4f}{' (piano row)' if fr else ''}; K3 "
            f"{c['flash_attention_lse']} K4 {c['flash_attention_bwd_dq']} "
            f"K5 {c['flash_attention_bwd_dkv']}")
    per_layer = cfg.model.depth * 4
    expect = dict.fromkeys(fa.launch_counts, 0)
    expect.update(flash_attention_lse=2 * per_layer,
                  flash_attention_bwd_dq=per_layer,
                  flash_attention_bwd_dkv=per_layer)
    db, st = (float(np.median(x[1:])) for x in (rec["db"], rec["step"]))
    audio_s = TRAIN_BATCH * CLIP_S
    split = {kind: [w for w, fr in zip(rec["step"][1:], rec["frames"][1:])
                    if fr == piano] for kind, piano in (("with", True),
                                                        ("without", False))}
    log(f"  {CORPUS_STEPS} timed steps (after one warm-up): median "
        f"device_batch {db:.4f} s + train step {st:.4f} s = "
        f"{db + st:.4f} s a step, {audio_s / (db + st):.2f} training "
        f"audio-s per s; train step median "
        + ", ".join(f"{k} the piano row {np.median(v):.4f} s ({len(v)})"
                    for k, v in split.items() if v)
        + f"; peak memory {peak / 2**30:.2f} GiB; flash backward routes "
        f"{rec['routes']}")
    for step, secs, size in rec["saves"]:
        log(f"  checkpoint at step {step}: {size / 2**30:.2f} GiB "
            f"({size} bytes) written in {secs:.2f} s "
            f"({size / secs / 2**30:.2f} GiB/s)")
    work = tp.work_dir
    metrics = [json.loads(x) for x in
               open(os.path.join(work, "logs", "metrics.jsonl"))]
    beat = json.load(open(os.path.join(work, "heartbeat.json")))
    bad = []
    if final != 1 + CORPUS_STEPS:
        bad.append(f"fit ended at step {final}")
    if not all(np.isfinite(x).all() for x in rec["loss"]):
        bad.append("non-finite loss")
    if not any(rec["frames"]) or not all(
            midi > 0 for (_, _, midi), fr in zip(rec["loss"], rec["frames"])
            if fr):
        bad.append("no piano row, or a zero MIDI loss with one")
    if [s for s, _, _ in rec["saves"]] != list(range(
            CORPUS_SAVE_STEP, final + 1, CORPUS_SAVE_STEP)):
        bad.append(f"checkpoints at {rec['saves']}")
    if [m["step"] for m in metrics] != list(range(1, final + 1)) or \
            beat["step"] != final:
        bad.append(f"metrics {len(metrics)} records, heartbeat {beat}")
    if any(c != expect for c in rec["counts"]):
        bad.append(f"launches {rec['counts']} != {expect}")
    if rec["routes"].get("cuda_core") or not rec["routes"].get("wgmma"):
        bad.append(f"flash backward routes {rec['routes']}")
    if bad:
        raise RuntimeError("corpus train: " + "; ".join(bad))
    return tp, batcher


# --------------------------------------------------------------- phase 17

def trainer_states_equal(torch, a, b) -> list:
    """Names of the exact-state entries in which trainers ``a`` and ``b``
    differ: parameters and buffers, EMA, dropout generator, AdamW moments,
    step counts."""
    sa, sb = a.state_dict(), b.state_dict()
    diff = [f"model.{k}" for k, v in sa["model"].items()
            if not torch.equal(v, sb["model"][k])]
    diff += [f"ema.{k}" for k, v in sa["ema"].items()
             if not torch.equal(v, sb["ema"][k])]
    if not torch.equal(sa["rng"], sb["rng"]):
        diff.append("rng")
    oa, ob = sa["opt"]["adamw"]["state"], sb["opt"]["adamw"]["state"]
    diff += [f"opt.{i}.{k}" for i, st in oa.items() for k, v in st.items()
             if not torch.equal(v, ob[i][k])]
    if len(oa) != len(ob) or sa["opt"]["count"] != sb["opt"]["count"] or \
            sa["step"] != sb["step"]:
        diff.append("opt / step counts")
    return diff


def phase_resume_and_serve(torch, held: dict, root: str, frames,
                           device: str = "cuda") -> None:
    """A fresh ``TrainingPipeline`` on phase 16's work dir resumes at its
    last checkpoint, with the state of the pipeline that saved it, bit for
    bit, and takes one step; ``save_model`` writes its EMA CFM to
    ``serve/cfm``; a fresh serving pipeline (as phase 5's) loads it with
    ``load_weights`` and generates from phase 5's frames and x0, bit-equal
    (latents and waveform) to a pipeline given the same float32 state before
    ``cast_params``."""
    import numpy as np

    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.training.pipeline import TrainingPipeline
    from v2ap_torch.utils.checkpoint import MODEL_FILE, save_model
    from v2ap_torch.utils.jitting import cast_params

    old = held.pop("pipe")
    batcher = held.pop("batcher")
    t0 = time.perf_counter()
    tp = TrainingPipeline(corpus_config(), seed=0, work_dir=old.work_dir,
                          device=device)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = tp.resumer.maybe_resume()
    torch.cuda.synchronize()
    restore = time.perf_counter() - t0
    size = os.path.getsize(tp.resumer.mgr.path(step))
    diff = trainer_states_equal(torch, old.trainer, tp.trainer)
    log(f"  fresh pipeline {build:.2f} s; resumed at step {step} from "
        f"{size / 2**30:.2f} GiB in {restore:.2f} s "
        f"({size / restore / 2**30:.2f} GiB/s); state vs the saving "
        f"pipeline: {'bit-equal' if not diff else diff[:5]}")
    if step != old.trainer.step or diff:
        raise RuntimeError(f"resume: step {step} vs {old.trainer.step}, "
                           f"differs in {diff[:10]}")
    del old
    torch.cuda.empty_cache()
    batch = tp.device_batch(next(b for b in batcher if any(b.piano)))
    result = []

    def step():
        result.append(tp.trainer.train_step(batch))

    phase_profile(torch, "corpus train step with the piano row", step,
                  SM90_FWD[1:] + SM90_BWD)
    loss, bk = result[0]
    log(f"  the step after resume: step {tp.trainer.step}, loss "
        f"{loss.item():.4f}, midi {float(bk.midi):.4f}")
    if not (np.isfinite(loss.item()) and float(bk.midi) > 0):
        raise RuntimeError("resume: non-finite loss or a zero MIDI loss")
    tp.trainer.ema.copy_to(tp.pipe.cfm)
    serve = os.path.join(root, "serve")
    t0 = time.perf_counter()
    save_model(os.path.join(serve, "cfm"), tp.pipe.cfm, step=tp.trainer.step)
    secs = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(serve, "cfm", MODEL_FILE))
    log(f"  save_model(serve/cfm), the EMA CFM: {size / 2**30:.2f} GiB "
        f"({size} bytes) in {secs:.2f} s")
    del tp
    torch.cuda.empty_cache()

    def generate(pipe):
        latents = []
        decode = pipe.codec.decode
        pipe.codec.decode = lambda z: latents.append(z.clone()) or decode(z)
        wav, _ = pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                               frames_cache=[(frames, CLIP_S, 1)])
        return latents[0], wav

    pipe = full_pipeline(torch, "V2A serving", frame_stride=1)
    t0 = time.perf_counter()
    loaded = pipe.load_weights(serve)
    torch.cuda.synchronize()
    log(f"  load_weights(serve) -> {loaded} in "
        f"{time.perf_counter() - t0:.2f} s")
    if loaded != ["cfm"]:
        raise RuntimeError(f"load_weights gave {loaded}")
    lat_a, wav_a = generate(pipe)
    del pipe
    torch.cuda.empty_cache()
    state = torch.load(os.path.join(serve, "cfm", MODEL_FILE),
                       map_location="cpu", weights_only=True,
                       mmap=True)["state"]
    base = corpus_config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, remat=False),
        conditioning=dataclasses.replace(base.conditioning,
                                         feature_cache=False, frame_stride=1))
    ref = V2APipeline(cfg, seed=0, device=device, quantize_towers=False,
                      trainable_cfm=True)
    ref.cfm.load_state_dict(state)
    cast_params(ref.cfm, torch.bfloat16)
    ref.cfm.eval().requires_grad_(False)
    lat_b, wav_b = generate(ref)
    del ref
    torch.cuda.empty_cache()
    same = torch.equal(lat_a, lat_b) and np.array_equal(wav_a, wav_b)
    log(f"  generate from load_weights vs from the state before cast_params: "
        f"latents {tuple(lat_a.shape)} and {wav_a.shape[0]} samples "
        f"{'bit-equal' if same else 'DIFFER'} (max |latent diff| "
        f"{(lat_a - lat_b).abs().max().item():.3e})")
    if not same or not np.isfinite(wav_a).all():
        raise RuntimeError("serve: load_weights differs from cast_params")


# --------------------------------------------------------------- phase 18

DPO_STEPS = 4                      # timed DPO steps after the first
REFLOW_BATCH = 4                   # scripts' defaults: 4 x 736 latents
REFLOW_LATENTS = 736
REFLOW_STEPS = 3                   # distill steps (one pair batch each)
REF_SCALE = 0.02                   # synthetic reference weights' std


def phase_dpo(torch, label: str, trainer, batch) -> None:
    """DPO (and FactorCL where the trainer has it) at full width: the first
    step (its DPO term must be within 1e-2 of ln 2: the EMA shadow equals
    the model and draws the policy's dropout masks), DPO_STEPS timed ones
    (launches checked each step: K1 once per attention, N1 and N2 once
    per norm and gate for the reference forward without autograd, K3
    once, or twice under remat, K4 and K5 once), every term finite,
    FactorCL's term nonzero and its parameters moved; under remat the
    FactorCL tap must come out of the checkpointed layer 1 (a pair of
    tensors among its outputs, and from no other layer). Then one step under
    the profiler (tensor-core kernels only)."""
    import numpy as np

    from v2ap_torch.models import transformer as tmod
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    model = trainer.model
    con = trainer.fcl is not None
    per = model.cfg.depth * 4
    expect = dict.fromkeys(launch_counts, 0)
    expect.update(flash_attention_packed=per,
                  flash_attention_lse=per * (2 if model.cfg.remat else 1),
                  flash_attention_bwd_dq=per, flash_attention_bwd_dkv=per,
                  **norm_expect(model.cfg, 1))
    fcl_start = ([p.detach().clone() for p in trainer.fcl.parameters()]
                 if con else [])
    remat = tmod.remat
    taps = []

    def spy(fn, *args, **kw):
        out = remat(fn, *args, **kw)
        taps.append(len(out[4]))
        return out

    tmod.remat = spy
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, bk = trainer.train_step(batch)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    finally:
        tmod.remat = remat
    counts = dict(launch_counts)
    dpo1 = float(bk.dpo)
    log(f"  first step {first:.3f} s: loss {loss.item():.4f}, flow "
        f"{float(bk.flow):.4f}, dpo {dpo1:.6f} (ln 2 = {math.log(2):.6f}, "
        f"|diff| {abs(dpo1 - math.log(2)):.2e}, tol 1e-2), contrastive "
        f"{float(bk.contrastive):.6f}; launches {counts}")
    want_taps = ([2] + [0] * (model.cfg.depth - 1) if con
                 else [0] * model.cfg.depth) if model.cfg.remat else []
    if taps != want_taps:
        raise RuntimeError(f"{label}: the checkpointed layers returned "
                           f"tapped hiddens {taps}, expected {want_taps}")
    if model.cfg.remat and con:
        log(f"  FactorCL tap: layer 1's (audio, CLIP-stream) hiddens are "
            f"outputs of its checkpointed call ({model.cfg.remat_policy}); "
            f"the other {model.cfg.depth - 1} layers return none")
    if abs(dpo1 - math.log(2)) > 1e-2 or counts != expect:
        raise RuntimeError(f"{label}: first DPO term {dpo1} (not ln 2) or "
                           f"launches {counts} != {expect}")
    torch.cuda.reset_peak_memory_stats()
    walls, terms = [], []
    for _ in range(DPO_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, bk = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if dict(launch_counts) != expect:
            raise RuntimeError(f"{label}: launches {dict(launch_counts)} != "
                               f"{expect}")
        terms.append((loss.item(), float(bk.flow), float(bk.dpo),
                      float(bk.contrastive)))
    peak = torch.cuda.max_memory_allocated()
    terms = np.asarray(terms)
    moved = (max((p - q).abs().max().item() for p, q in
                 zip(trainer.fcl.parameters(), fcl_start)) if con else 0.0)
    wall = float(np.median(walls))
    audio_s = TRAIN_BATCH * TRAIN_LATENTS / 75.0
    log(f"  {label} x{DPO_STEPS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s, "
        f"{audio_s / wall:.2f} training audio-s per s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches per step {expect}")
    log(f"  loss / flow / dpo / contrastive per step: "
        + "; ".join(" / ".join(f"{x:.4f}" for x in row) for row in terms)
        + (f"; FactorCL max |param change| {moved:.3e}" if con else ""))
    if not np.isfinite(terms).all():
        raise RuntimeError(f"{label}: a non-finite term {terms}")
    if con and not (np.all(terms[:, 3] != 0.0) and moved > 0):
        raise RuntimeError(f"{label}: contrastive {terms[:, 3]} or FactorCL "
                           f"moved {moved}")

    def step():
        loss, _ = trainer.train_step(batch)
        if not torch.isfinite(loss):
            raise RuntimeError(f"{label} profile: non-finite loss")

    phase_profile(torch, label, step, SM90_FWD[1:] + SM90_BWD)


# --------------------------------------------------------------- phase 19

def phase_reflow(torch, frames, root: str):
    """Reflow at full width: the teacher (v2a_default(), seed 0) draws
    REFLOW_BATCH x REFLOW_LATENTS pairs with its 25-step sway CFG sampler
    (K1 24 x 48 times a batch), the student (the teacher's weights) takes
    REFLOW_STEPS distill steps (K3-K5 48 times each); the student goes to
    disk with save_model, into a serving pipeline (phase 5's) with
    load_weights, and samples a 10 s clip with generate(fewstep=2). Returns
    the pipeline."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.training.distill import (ReflowConfig, ReflowDistiller,
                                             make_pair_sampler)
    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.device import seeded_init

    cfg = C.v2a_default()
    mc = cfg.model
    dev = torch.device("cuda")

    def build():
        with seeded_init(0, dev):
            return CFM(mc, cfg.conditioning, device=dev,
                       with_video2roll=mc.video2roll)

    teacher = build().eval().requires_grad_(False)
    student = build()
    student.load_state_dict(teacher.state_dict())
    rcfg = ReflowConfig()
    pairs = make_pair_sampler(teacher, rcfg)
    distiller = ReflowDistiller(student, rcfg)
    b, n = REFLOW_BATCH, REFLOW_LATENTS
    rng = np.random.default_rng(0)
    ctx = torch.zeros(b, 1, mc.dim_context, device=dev)
    ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=dev)
    mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    roll = torch.zeros(b, n, mc.notes, device=dev)
    lens = torch.full((b,), n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    per = mc.depth * 4
    pair_expect = dict.fromkeys(launch_counts, 0)
    # the sway schedule's teacher_steps times, teacher_steps - 1 evaluations
    pair_expect["flash_attention_packed"] = (rcfg.teacher_steps - 1) * per
    pair_expect.update(norm_expect(mc, rcfg.teacher_steps - 1))
    step_expect = dict.fromkeys(launch_counts, 0)
    step_expect.update(flash_attention_lse=per, flash_attention_bwd_dq=per,
                       flash_attention_bwd_dkv=per)
    pair_s, step_s, losses = [], [], []
    for _ in range(REFLOW_STEPS):
        text = torch.from_numpy(rng.normal(size=(b, n, mc.dim_text)).astype(
            np.float32)).to(dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        x0, x1 = pairs(text, roll, ctx, ctx_mask, mask, generator=gen)
        torch.cuda.synchronize()
        pair_s.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = distiller.distill_step(x0, x1, lens=lens, text_embed=text,
                                      context=ctx, context_mask=ctx_mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if counts != pair_expect or dict(launch_counts) != step_expect:
            raise RuntimeError(f"reflow: pair launches {counts} (expected "
                               f"{pair_expect}), step {dict(launch_counts)} "
                               f"(expected {step_expect})")
        if not (torch.isfinite(x1).all() and np.isfinite(losses[-1])):
            raise RuntimeError("reflow: non-finite pair or loss")
    log(f"  pairs {b} x {n} ({rcfg.teacher_steps} sway steps, CFG "
        f"{rcfg.cfg_strength}): "
        f"{', '.join(f'{t:.3f}' for t in pair_s)} s a batch (K1 "
        f"{pair_expect['flash_attention_packed']} a batch); distill steps "
        f"{', '.join(f'{t:.3f}' for t in step_s)} s (K3-K5 {per} each), "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    path = os.path.join(root, "reflow")
    t0 = time.perf_counter()
    save_model(path, student, step=distiller.step)
    save_s = time.perf_counter() - t0
    del teacher, student, distiller, pairs
    torch.cuda.empty_cache()
    pipe = full_pipeline(torch, "V2A", frame_stride=1)
    t0 = time.perf_counter()
    loaded = pipe.load_weights(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        wav, sr = pipe.generate(None, fewstep=2, seed=0,
                                frames_cache=[(frames, CLIP_S, 1)])
        walls.append(time.perf_counter() - t0)
    log(f"  student saved in {save_s:.2f} s, load_weights -> {loaded} in "
        f"{load_s:.2f} s; generate(fewstep=2): {wav.shape[0]} samples at "
        f"{sr} Hz, walls {walls[0]:.3f} s (captures) and {walls[1]:.3f} s")
    if loaded != ["cfm"] or wav.shape[0] != int(CLIP_S * sr) or \
            not np.isfinite(wav).all():
        raise RuntimeError(f"reflow: load_weights {loaded} or a bad "
                           f"few-step waveform")
    return pipe


# --------------------------------------------------------------- phase 20

def phase_reference(torch, pipe, frames, root: str) -> None:
    """The reference's checkpoint layout at full width: a synthetic
    crossatt3 ``.pt`` (every key and shape of ``reference_manifest``,
    gaussian values of std REF_SCALE from seed 0) under ``root``;
    ``python -m v2ap_torch.convert`` writes ``root/converted/cfm``; a
    strict load leaves no key; the q rows of a self-attention are the
    state dict's, permuted to the half-split rotary pairs; the serving
    pipeline's ``load_weights`` takes the converted CFM and generates a
    finite 10 s clip; the ``.pt`` is removed. Then a crossatt6 ``.pt``'s
    state dict into a seeded crossatt6 CFM on the card: only the FactorCL
    tower's keys left, ``to_frames`` and ``proj_frames`` zero."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.convert import build_cfm
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.utils.device import seeded_init
    from v2ap_torch.utils.reference_ckpt import (
        _rope_permute, load_cfm_from_reference_state_dict,
        load_reference_checkpoint)
    from v2ap_torch.utils.reference_manifest import reference_manifest

    mc = C.v2a_default().model

    def synthetic(variant: str, seed: int) -> dict:
        g = torch.Generator().manual_seed(seed)
        return {k: torch.randn(shape, generator=g) * REF_SCALE
                for k, shape in reference_manifest(mc, variant).items()}

    t0 = time.perf_counter()
    sd = synthetic("crossatt3", 0)
    pt = os.path.join(root, "crossatt3.pt")
    torch.save({"model_state_dict": sd}, pt)
    size = os.path.getsize(pt)
    log(f"  synthetic crossatt3 .pt: {len(sd)} keys, "
        f"{sum(v.numel() for v in sd.values()) / 1e6:.1f} M values, "
        f"{size / 2**30:.2f} GiB, written in {time.perf_counter() - t0:.2f} s")
    out = os.path.join(root, "converted")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "v2ap_torch.convert",
                          "--cfm-ckpt", pt, "--out", out], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    log(f"  python -m v2ap_torch.convert: exit {res.returncode} in "
        f"{convert_s:.2f} s: {res.stdout.strip()[-200:]}")
    if res.returncode != 0:
        raise RuntimeError(f"convert failed: {res.stderr[-2000:]}")
    cfm = build_cfm(51)
    t0 = time.perf_counter()
    left = load_reference_checkpoint(pt, cfm, strict=True)
    strict_s = time.perf_counter() - t0
    q = sd["transformer.layers.0.0.3.to_q.weight"]
    inner = mc.heads * mc.dim_head
    want_q = _rope_permute(q, mc.heads, mc.dim_head, mc.dim_head)
    qkv = cfm.transformer.audio_blocks[0].attn.to_qkv.weight.detach()
    rows_ok = (torch.equal(qkv[:inner], want_q) and torch.equal(qkv[1], q[2])
               and torch.equal(qkv[mc.dim_head // 2], q[1]))
    log(f"  strict load on the host in {strict_s:.2f} s: {len(left)} keys "
        f"left; layer 0's q rows are the state dict's in half-split order "
        f"(row 1 = row 2, row {mc.dim_head // 2} = row 1): {rows_ok}")
    if left or not rows_ok:
        raise RuntimeError(f"reference: strict load left {left[:5]} or the "
                           f"q rows are not the permuted state dict's")
    del cfm
    t0 = time.perf_counter()
    loaded = pipe.load_weights(out)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    served = pipe.cfm.transformer.audio_blocks[0].attn.to_qkv.weight
    served_ok = torch.equal(served[:inner].cpu(), want_q.to(served.dtype))
    t0 = time.perf_counter()
    wav, sr = pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                            frames_cache=[(frames, CLIP_S, 1)])
    gen_s = time.perf_counter() - t0
    os.remove(pt)
    log(f"  load_weights -> {loaded} in {load_s:.2f} s (served q rows "
        f"{served.dtype}, equal to the permuted state dict's: {served_ok}); "
        f"V2A generate {gen_s:.3f} s (captures): {wav.shape[0]} samples, "
        f"finite {bool(np.isfinite(wav).all())}; .pt removed "
        f"{not os.path.exists(pt)}")
    if loaded != ["cfm"] or not served_ok or os.path.exists(pt) or \
            wav.shape[0] != int(CLIP_S * sr) or not np.isfinite(wav).all():
        raise RuntimeError("reference: load_weights or generate failed")
    cfg6 = C.variant_preset("crossatt6")
    sd6 = synthetic("crossatt6", 1)
    with seeded_init(0, torch.device("cuda")):
        cfm6 = CFM(cfg6.model, cfg6.conditioning, device="cuda")
    ccs = [cc for cc in cfm6.transformer.cross_conditions
           if cc.cond_audio_to_others]
    with torch.no_grad():        # the fusions start at zero: make them not
        for w in [cc.to_frames.weight for cc in ccs] + [
                cfm6.proj_frames.weight, cfm6.proj_frames.bias]:
            w.fill_(1.0)
    before = (all(cc.to_frames.weight.abs().sum() > 0 for cc in ccs)
              and cfm6.proj_frames.weight.abs().sum() > 0)
    t0 = time.perf_counter()
    left = load_cfm_from_reference_state_dict(sd6, cfm6, strict=True)
    torch.cuda.synchronize()
    load6_s = time.perf_counter() - t0
    inert = (all(not cc.to_frames.weight.any() for cc in ccs)
             and not cfm6.proj_frames.weight.any()
             and not cfm6.proj_frames.bias.any())
    others = [k for k in left
              if not k.startswith("transformer.contrastive_loss.")]
    log(f"  crossatt6 state dict ({len(sd6)} keys) into a seeded crossatt6 "
        f"CFM on the card in {load6_s:.2f} s: {len(left)} FactorCL keys "
        f"left, {len(others)} others; to_frames ({len(ccs)} layers) and "
        f"proj_frames set nonzero before {bool(before)}, zero after "
        f"{inert}")
    if others or not left or not before or not inert:
        raise RuntimeError("reference: the crossatt6 load is wrong")
    del cfm6, sd6
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 21

EVAL_CLIPS = 4                     # rows of the eval manifest
EVAL_STEPS = 25
EVAL_REPS = 5                      # timed evaluator calls (median)
EVAL_REL_RMS = 1e-3                # evaluators card vs CPU, f32
EVAL_SIM_ATOL = 1e-4               # CLAP similarity card vs CPU
EVAL_SAME_REL_RMS = 1e-3           # a CLI's wav vs this process's, same clip
EVAL_CAPTION = "a dog barks while rain falls on a tin roof"


def events_ms(torch, fn, reps: int = EVAL_REPS) -> list:
    """``fn()`` timed ``reps`` times by CUDA events after one warm-up call,
    each time in ms."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def phase_evaluators(torch) -> None:
    """PANN Cnn14 (``pann_16k()``, 527 classes) and CLAP
    (``clap_htsat_unfused()``) at full width from seeded weights, on the
    card and on the CPU from the same weights, over a seeded 10 s 24 kHz
    clip (resampled on the host to 16 and 48 kHz) and EVAL_CAPTION: the
    embedding and logits, the audio and text features within EVAL_REL_RMS
    relative RMS, the similarity within EVAL_SIM_ATOL; then the card's ms
    per clip (CUDA events, median of EVAL_REPS): Cnn14's joint pass from
    the 16 kHz waveform, CLAP from the 48 kHz waveform (log-mel on the
    card, bicubic resize to 1024 frames, both towers)."""
    import numpy as np

    from v2ap_torch.data.audio_io import resample
    from v2ap_torch.evaluation.clap_scorer import _fallback_tokenize
    from v2ap_torch.evaluation.pann import Cnn14, pann_16k
    from v2ap_torch.models.clap import ClapModel, clap_htsat_unfused, clap_logmel
    from v2ap_torch.utils.device import seeded_init

    cuda = torch.device("cuda")
    wav = (np.random.default_rng(21).normal(size=(1, int(CLIP_S * 24_000)))
           * 0.1).astype(np.float32)
    with seeded_init(0, cuda):
        card = Cnn14(pann_16k(), device=cuda).eval()
    cpu = Cnn14(pann_16k(), device="cpu").eval()
    cpu.load_state_dict(card.state_dict())
    w16 = torch.from_numpy(resample(wav, 24_000, 16_000))
    w16_card = w16.to(cuda)

    def joint(model, w):
        emb = model(w)
        return emb, model.fc_audioset(emb)

    with torch.inference_mode():
        e_card, l_card = joint(card, w16_card)
        e_cpu, l_cpu = joint(cpu, w16)
        ms = events_ms(torch, lambda: joint(card, w16_card))
    errs = (rel_rms(e_card.cpu(), e_cpu), rel_rms(l_card.cpu(), l_cpu))
    log(f"  Cnn14 (pann_16k, 527 classes) card vs CPU over a 10 s clip: "
        f"embedding {tuple(e_card.shape)} rel-RMS {errs[0]:.3e}, logits "
        f"{tuple(l_card.shape)} {errs[1]:.3e} (tol {EVAL_REL_RMS}); ms per "
        f"clip on the card {', '.join(f'{m:.3f}' for m in ms)}, median "
        f"{float(np.median(ms)):.3f}")
    if e_card.shape != (1, 2048) or l_card.shape != (1, 527) or \
            max(errs) > EVAL_REL_RMS:
        raise RuntimeError(f"evaluate: Cnn14 card vs CPU {errs}")
    del card, cpu, e_card, l_card
    torch.cuda.empty_cache()

    a_cfg, t_cfg = clap_htsat_unfused()
    with seeded_init(0, cuda):
        card = ClapModel(a_cfg, t_cfg, device=cuda).eval()
    cpu = ClapModel(a_cfg, t_cfg, device="cpu").eval()
    cpu.load_state_dict(card.state_dict())
    w48 = torch.from_numpy(resample(wav, 24_000, 48_000))
    w48_card = w48.to(cuda)
    ids, mask = (torch.from_numpy(x).long() for x in
                 _fallback_tokenize([EVAL_CAPTION], t_cfg.vocab_size))
    ids_card, mask_card = ids.to(cuda), mask.to(cuda)
    tmax = a_cfg.spec_size * a_cfg.freq_ratio

    def features(model, w, i, m):
        feats = clap_logmel(w, n_mels=a_cfg.num_mel_bins)[:, :, :tmax]
        return (feats.shape, model.get_audio_features(feats),
                model.get_text_features(i, m))

    with torch.inference_mode():
        shape, a_card, t_card = features(card, w48_card, ids_card, mask_card)
        _, a_cpu, t_cpu = features(cpu, w48, ids, mask)
        ms = events_ms(torch, lambda: features(card, w48_card, ids_card,
                                               mask_card))
    s_card = float((a_card * t_card).sum().item())
    s_cpu = float((a_cpu * t_cpu).sum().item())
    errs = (rel_rms(a_card.cpu(), a_cpu), rel_rms(t_card.cpu(), t_cpu))
    log(f"  CLAP (htsat-unfused) card vs CPU: log-mel {tuple(shape)} resized "
        f"to {tmax} frames; audio features rel-RMS {errs[0]:.3e}, text "
        f"features {errs[1]:.3e} (tol {EVAL_REL_RMS}); similarity card "
        f"{s_card:.6f}, CPU {s_cpu:.6f} (|diff| {abs(s_card - s_cpu):.2e}, "
        f"tol {EVAL_SIM_ATOL}); ms per clip on the card "
        f"{', '.join(f'{m:.3f}' for m in ms)}, median "
        f"{float(np.median(ms)):.3f}")
    if tuple(shape) != (1, 1, 1001, 64) or max(errs) > EVAL_REL_RMS or \
            abs(s_card - s_cpu) > EVAL_SIM_ATOL:
        raise RuntimeError(f"evaluate: CLAP card vs CPU {errs}, "
                           f"{s_card} vs {s_cpu}")
    del card, cpu
    torch.cuda.empty_cache()


def eval_corpus(root: str) -> tuple:
    """EVAL_CLIPS rows of absent .mp4 videos with captions in ``eval.scp``,
    one piano row in ``piano.scp``, and ``refs/``: seeded 10 s 24 kHz wavs
    with the eval rows' basenames. Returns (eval scp, piano scp, ref dir,
    {video path: seeded frames}, the piano video's strips, {video path:
    caption})."""
    import numpy as np

    from v2ap_torch.data.audio_io import write_wav

    rng = np.random.default_rng(22)
    t = int(CLIP_S * FPS)
    refs = os.path.join(root, "refs")
    os.makedirs(os.path.join(root, "videos"))   # the caches go beside them
    videos, rows = {}, []
    for i in range(EVAL_CLIPS + 1):
        stem = f"clip{i}" if i < EVAL_CLIPS else "piano0"
        path = os.path.join(root, "videos", stem + ".mp4")
        videos[path] = rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8)
        rows.append((path, f"{EVAL_CAPTION} {i}"))
        if i < EVAL_CLIPS:
            write_wav(os.path.join(refs, stem + ".wav"),
                      (rng.normal(size=int(CLIP_S * 24_000))
                       * rng.uniform(0.05, 0.2)).astype(np.float32))
    strips = rng.integers(0, 256, (t, 100, 900), dtype=np.uint8)
    scps = []
    for name, part in (("eval.scp", rows[:EVAL_CLIPS]),
                       ("piano.scp", rows[EVAL_CLIPS:])):
        scps.append(os.path.join(root, name))
        with open(scps[-1], "w") as f:
            f.writelines(f"{p}\t{c}\n" for p, c in part)
    return scps[0], scps[1], refs, videos, strips, dict(rows)


def check_wavs(torch, out: str, same: dict) -> None:
    """Every generated wav: 240 000 finite samples at 24 kHz, within
    EVAL_SAME_REL_RMS of the wav that the pipeline in this process made
    for the same clip, prompt and seed from the decoded frames (``same``:
    stem -> that waveform, read back from its 16-bit file). A CLI that missed a cache would have generated
    without the clip's features (zeros), audibly another waveform."""
    import numpy as np

    from v2ap_torch.data.audio_io import read_wav

    errs = {}
    for stem, want in same.items():
        wav, sr = read_wav(os.path.join(out, stem + ".wav"))
        if sr != 24_000 or wav.shape != (1, int(CLIP_S * 24_000)) or \
                not np.isfinite(wav).all():
            raise RuntimeError(f"evaluate: {stem}.wav {wav.shape} at {sr}")
        errs[stem] = rel_rms(torch.from_numpy(wav[0]), torch.from_numpy(want))
    log(f"  the CLI's wavs against this process's (rel-RMS, 16-bit files): "
        f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tol "
        f"{EVAL_SAME_REL_RMS})")
    if max(errs.values()) > EVAL_SAME_REL_RMS:
        raise RuntimeError(f"evaluate: the CLI's audio differs from the "
                           f"in-process audio of the same clips: {errs}")


def run_cli(args: list, label: str, env: dict | None = None,
            out: list | None = None, wall_shown: bool = True) -> float:
    """``python -m <args>`` from the repository root, with ``env`` added to
    the environment; returns its wall (its standard output appended to
    ``out``), printed unless ``wall_shown`` is false."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    if out is not None:
        out.append(res.stdout)
    log(f"  python -m {args[0]}: exit {res.returncode}"
        + (f" in {wall:.2f} s" if wall_shown else ""))
    if res.returncode != 0:
        raise RuntimeError(f"{label} failed: {res.stdout[-1500:]}\n"
                           f"{res.stderr[-3000:]}")
    return wall


def phase_eval(torch, root: str) -> None:
    """The batch evaluation path over the seeded manifest (``eval_corpus``)
    at the CLIs' configuration, ``V2APConfig()`` (frame stride 3, strip
    stride 2, feature caches on), bf16 towers, seed 0.

    In this process first, ``run_batch_eval`` over the EVAL_CLIPS rows with
    each clip's decoded frames handed to ``generate`` (no cv2 here) and
    the launch counters zeroed just before each clip's generate and read
    just after: K2 48 x (tower chunks), no other kernel from the host (as
    phase 5), after one V2P generate of the piano row from its frames and
    strips (with a prompt: it captures the sampler program the prompted
    clips replay) which writes that row's features and roll (at strip
    stride 2 the roll cache serves). The tower writes each clip's feature
    cache beside its video. The pipeline's CFM is saved as the checkpoint
    the V2P CLI names.

    Then the CLIs as their own processes, reading those caches: ``python
    -m v2ap_torch.evaluate --steps 25 --ref-dir refs --clap`` and ``python
    -m v2ap_torch.inference_v2p <ckpt> 0 piano.scp 0 1 <out> --steps 25``.
    Both must exit 0 with every row succeeded; FAD, IS and both KLs
    finite, a finite CLAP score in [-1, 1] per clip; 240 000 finite
    samples in every wav, within EVAL_SAME_REL_RMS of what this process
    made for the same clip, prompt and seed, both as 16-bit files (so the
    caches served), with the CLIs' TF32 switches (PyTorch's defaults)."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.data.audio_io import read_wav, write_wav
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.pipelines.batch_eval import run_batch_eval
    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.utils.checkpoint import save_model

    scp, piano_scp, refs, videos, strips, captions = eval_corpus(root)
    # the CLIs run with PyTorch's default TF32 switches (cuDNN's on, for
    # EnCodec's f32 convolutions); this process takes them until the CLIs
    # have run, so that their wavs can be held to this process's
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        pipe = V2APipeline(C.V2APConfig(), seed=0, device="cuda",
                           quantize_towers=False)
        log(f"  built the CLIs' pipeline (V2APConfig(): frame stride "
            f"{pipe.frame_stride}, strip stride {pipe.strip_stride}) in "
            f"{time.perf_counter() - t0:.2f} s")
        expect = generate_expect(pipe, int(CLIP_S * FPS))
        # the piano row first, with the V2P CLI's prompt and seed: it also
        # captures the sampler program that the prompted clips below replay
        piano = next(p for p in videos if "piano" in p)
        t0 = time.perf_counter()
        piano_wav, _ = pipe.generate(
            piano, "the sound of " + captions[piano], steps=EVAL_STEPS,
            piano=True, seed=0, frames_cache=[(videos[piano], CLIP_S, 1)],
            strips_cache=[(strips, CLIP_S)])
        if not np.isfinite(piano_wav).all():
            raise RuntimeError("evaluate: the piano row's priming generate")
        log(f"  the piano row's V2P generate (writes its features and roll): "
            f"{time.perf_counter() - t0:.2f} s with the sampler's capture")
        counts = []

        class DecodedClips:
            """``run_batch_eval``'s pipeline: each video's frames handed in."""

            def generate(self, path, prompt, **kw):
                torch.cuda.synchronize()
                reset_launch_counts()
                out = pipe.generate(path, prompt, frames_cache=[
                    (videos[path], CLIP_S, 1)], **kw)
                counts.append(dict(launch_counts))
                return out

        # the evaluate CLI's arguments: the caption as the prompt, seed 0 + i
        inproc = os.path.join(root, "inproc")
        summary = run_batch_eval(DecodedClips(), scp, inproc, steps=EVAL_STEPS)
        log(f"  run_batch_eval in this process, {EVAL_CLIPS} clips: {summary}; "
            f"launches by the wrappers per clip {counts} (expected {expect})")
        if summary["succeeded"] != EVAL_CLIPS or summary["failed"] or \
                len(counts) != EVAL_CLIPS or any(c != expect for c in counts):
            raise RuntimeError(f"evaluate: in-process batch eval {summary}, "
                               f"launches {counts}")
        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        save_model(os.path.join(ckpt, "cfm"), pipe.cfm)
        log(f"  saved the CFM for the V2P CLI in {time.perf_counter() - t0:.2f} s")
        del pipe
        torch.cuda.empty_cache()

        out = os.path.join(root, "eval_out")
        wall = run_cli(["v2ap_torch.evaluate", "--scp", scp, "--out", out,
                        "--steps", str(EVAL_STEPS), "--ref-dir", refs, "--clap"],
                       "python -m v2ap_torch.evaluate")
        with open(os.path.join(out, "summary.json")) as f:
            s = json.load(f)
        clap = [r["clap"] for r in s.get("clap_scores", [])]
        log(f"  evaluate: wall {wall:.2f} s (its own process), "
            f"{s['succeeded']}/{s['clips']} clips, realtime factor "
            f"{s['realtime_factor']} (generate walls), FAD {s.get('fad')}, IS "
            f"{s.get('is_mean')} +- {s.get('is_std')}, KL softmax "
            f"{s.get('kl_softmax')}, sigmoid {s.get('kl_sigmoid')}, metrics "
            f"{s.get('metrics_seconds')} s, CLAP {clap} (mean "
            f"{s.get('clap_mean')})")
        finite = all(np.isfinite(s.get(k, np.nan)) for k in
                     ("fad", "is_mean", "kl_softmax", "kl_sigmoid"))
        if s["succeeded"] != EVAL_CLIPS or s["failed"] or not finite or \
                len(clap) != EVAL_CLIPS or \
                not all(np.isfinite(c) and -1.0 <= c <= 1.0 for c in clap):
            raise RuntimeError(f"evaluate: the CLI's summary {s}")
        check_wavs(torch, out, {
            f"clip{i}": read_wav(os.path.join(inproc, f"clip{i}.wav"))[0][0]
            for i in range(EVAL_CLIPS)})

        out = os.path.join(root, "v2p_out")
        wall = run_cli(["v2ap_torch.inference_v2p", ckpt, "0", piano_scp, "0",
                        "1", out, "--steps", str(EVAL_STEPS)],
                       "python -m v2ap_torch.inference_v2p")
        with open(os.path.join(out, "summary.json")) as f:
            s = json.load(f)
        log(f"  inference_v2p (positional form): wall {wall:.2f} s (its own "
            f"process), {s['succeeded']}/{s['clips']} clips, realtime factor "
            f"{s['realtime_factor']}")
        if s["succeeded"] != 1 or s["failed"]:
            raise RuntimeError(f"evaluate: the V2P CLI's summary {s}")
        write_wav(os.path.join(inproc, "piano0.wav"), piano_wav)
        check_wavs(torch, out, {
            "piano0": read_wav(os.path.join(inproc, "piano0.wav"))[0][0]})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# -------------------------------------------------------------- phase 22

TOWER_RUNS = 2                     # timed mixed-mode generates (median)
HD_FRAME = (720, 1280)             # (h, w) of the mixed generate's 720p frames
TOWER_CHUNKS = math.ceil(CLIP_S * FPS / 64)   # 64-frame tower chunks


def tower_small_configs():
    """Small f32 configs of the four towers whose attention head dims K2
    takes (the port's ``clip_tiny_test`` has head dim 8, which no kernel
    is built for): ViT-bigG-like (exact GELU, d 32), the quick-GELU ViT-L
    miniature (d 64), ``dinov2_tiny_test`` and ``convnext_tiny_test``."""
    from v2ap_torch.models.clip_vit import CLIPVisionConfig
    from v2ap_torch.models.convnext import convnext_tiny_test
    from v2ap_torch.models.dinov2 import dinov2_tiny_test

    return {"clip_vit": CLIPVisionConfig(
                hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=2, image_size=28, patch_size=14, projection_dim=16,
                dtype="float32"),
            "clip_vit2": CLIPVisionConfig(
                hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=2, image_size=42, patch_size=14, projection_dim=12,
                hidden_act="quick_gelu", dtype="float32"),
            "clip_convnext": convnext_tiny_test(),
            "dinov2": dinov2_tiny_test()}


def phase_towers_small(torch) -> None:
    """A mixed-mode pipeline of the four small f32 towers on the card and
    on the CPU, same weights: each tower's features of the same 28x28
    frames (resized to 42 and 32 px on each device) within SMALL_REL_RMS;
    K2 must have run for the two CLIP towers."""
    from v2ap_torch import config as C
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.pipelines.generate import V2APipeline

    towers = tower_small_configs()
    base = C.tiny_tower_test()
    cfg = base.replace(
        model=dataclasses.replace(base.model, dim_text_raw=84),
        conditioning=dataclasses.replace(base.conditioning,
                                         video_encoder="mixed",
                                         frame_stride=1, feature_cache=False))
    pipes = [V2APipeline(cfg, seed=2, device=dev, tower_configs=towers,
                         quantize_towers=False) for dev in ("cuda", "cpu")]
    for a, b in zip(pipes[0].towers, pipes[1].towers):
        b.model.load_state_dict(a.model.state_dict())
    frames = __import__("numpy").random.default_rng(3).integers(
        0, 256, (12, 28, 28, 3), dtype="uint8")
    reset_launch_counts()
    feats = [p.encode_video_frames_clip(None, 96,
                                        frames_cache=[(frames, 1.0, 1)])[0]
             for p in pipes]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    start = 0
    for tower in pipes[0].towers:
        end = start + tower.embed_dim
        g, c = feats[0][:, start:end].cpu(), feats[1][:, start:end]
        start = end
        err = rel_rms(g, c)
        log(f"  small f32 {tower.name} ({tower.model.cfg.image_size}px, "
            f"{tower.embed_dim}-d): rel-RMS card vs CPU {err:.2e} (tol "
            f"{SMALL_REL_RMS})")
        if not (torch.isfinite(g).all() and err <= SMALL_REL_RMS):
            raise RuntimeError(f"towers small: {tower.name} disagrees")
    want = sum(towers[n].num_layers for n in ("clip_vit", "clip_vit2"))
    if counts["flash_attention"] != want:
        raise RuntimeError(f"towers small: K2 launched "
                           f"{counts['flash_attention']} times, not {want}")
    dinov2_bf16_attention(torch)


def dinov2_bf16_attention(torch) -> None:
    """DINOv2-giant's attention layer (1536 wide, 24 heads of 64) in bf16 on
    257 tokens: the card's tensor-core products (float32 accumulation and
    result) against the CPU's widened float32 ones, same weights, within
    2^-8 rel-RMS (one bf16 rounding of the products and the output)."""
    from v2ap_torch.models.dinov2 import Dinov2Attention, dinov2_giant

    cfg = dinov2_giant()
    cpu = Dinov2Attention(cfg, dtype=torch.bfloat16, device="cpu")
    card = Dinov2Attention(cfg, dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 257, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(4)).bfloat16()
    with torch.no_grad():
        err = rel_rms(card(x.cuda()).float().cpu(), cpu(x).float())
    log(f"  DINOv2-giant bf16 attention (4, 257, 1536): rel-RMS card vs CPU "
        f"{err:.2e} (tol {2.0 ** -8:.2e})")
    if not err <= 2.0 ** -8:
        raise RuntimeError("towers small: DINOv2 bf16 attention disagrees")


def tower_pipeline(torch, mode: str, raw: int):
    """v2a_default() with video encoder ``mode`` (``raw``-d features into
    ``proj_text``), frame stride 1, no feature caches, seed 0 on the card,
    bf16 towers."""
    from v2ap_torch import config as C
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    cfg = base.replace(
        model=dataclasses.replace(base.model, dim_text_raw=raw),
        conditioning=dataclasses.replace(base.conditioning, video_encoder=mode,
                                         frame_stride=1, feature_cache=False))
    t0 = time.perf_counter()
    pipe = V2APipeline(cfg, seed=0, device="cuda", quantize_towers=False)
    torch.cuda.synchronize()
    sizes = ", ".join(
        f"{t.name} {sum(p.numel() for p in t.model.parameters()) / 1e6:.1f} M "
        f"bf16 at {t.model.cfg.image_size}px" for t in pipe.towers)
    log(f"  build full-width {mode} pipeline: {time.perf_counter() - t0:.2f} "
        f"s ({sizes}; video_embed_dim {pipe.video_embed_dim})")
    return pipe


def tower_generate(torch, pipe, frames, label: str, expect_k2: int,
                   runs: int, stats: dict | None = None) -> int:
    """One warm-up generate, then ``runs`` timed ones from ``frames``
    (empty prompt, 25 steps), the launch counters zeroed before each and
    read after: K2 ``expect_k2`` times, K1, N1 and N2 the sampler
    replay's ``k1_expect`` and ``norm_expect``, Q1 and Q2 the towers'
    ``int8_tower_calls`` (the towers run eagerly) and nothing else. Every wall,
    each tower's seconds and the realtime factor printed, and put in
    ``stats`` (``wall``, ``video_encode_s``: medians). Returns K2's
    launches of the last run."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    def gen():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    t0 = time.perf_counter()
    gen()
    torch.cuda.synchronize()
    log(f"  {label}: warm-up generate {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    expect = {**dict.fromkeys(launch_counts, 0), "flash_attention": expect_k2,
              "flash_attention_packed": k1_expect(pipe),
              **norm_expect(pipe.cfg.model, 25 - 1),
              **int8_expect(int8_tower_calls(pipe, len(frames)))}
    walls, towers, encodes = [], [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wav, sr = gen()
        walls.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        towers.append(dict(pipe.tower_seconds))
        encodes.append(pipe.last_timings["video_encode_s"])
        if wav.shape != (int(CLIP_S * sr),) or not np.isfinite(wav).all():
            raise RuntimeError(f"{label}: bad waveform {wav.shape}")
        if counts != expect:
            raise RuntimeError(f"{label}: launch counts {counts} != {expect}")
        log(f"  {label} run: wall {walls[-1]:.4f} s; stages (s) "
            + ", ".join(f"{k} {pipe.last_timings[k]:.4f}"
                        for k in stage_keys(pipe.last_timings))
            + "; video_encode_s by tower (s) "
            + ", ".join(f"{k} {v:.4f}" for k, v in towers[-1].items()))
    wall = float(np.median(walls))
    log(f"  {label} 10 s clip x{runs}: median wall {wall:.4f} s, realtime "
        f"factor {CLIP_S / wall:.3f}x; median by tower (s) "
        + ", ".join(f"{k} {np.median([t[k] for t in towers]):.4f}"
                    for k in towers[0])
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches {counts}; waveform {wav.shape} finite")
    if stats is not None:
        stats.update(wall=wall, walls=walls,
                     video_encode_s=float(np.median(encodes)))
    return counts["flash_attention"]


def phase_towers(torch, frames) -> int:
    """Phase 22. Returns K2's launches in one clip_vit2 generate (CLIP-L
    alone)."""
    phase_towers_small(torch)
    pipe = tower_pipeline(torch, "mixed", 4608)
    tower_generate(torch, pipe, frames, "mixed (4 towers, 4608-d)",
                   (48 + 24) * TOWER_CHUNKS, TOWER_RUNS)
    # the same clip at a camera's resolution: every tower resizes on the card
    gen = torch.Generator(device="cuda").manual_seed(22)
    hd = torch.randint(0, 256, (len(frames),) + HD_FRAME + (3,),
                       generator=gen, device="cuda",
                       dtype=torch.uint8).cpu().numpy()
    tower_generate(torch, pipe, hd, f"mixed at {HD_FRAME[1]}x{HD_FRAME[0]}",
                   (48 + 24) * TOWER_CHUNKS, 1)
    del pipe, hd
    torch.cuda.empty_cache()
    pipe = tower_pipeline(torch, "clip_vit2", 768)
    k2 = tower_generate(torch, pipe, frames, "clip_vit2 (ViT-L/336)",
                        24 * TOWER_CHUNKS, 1)
    del pipe
    torch.cuda.empty_cache()
    return k2


# -------------------------------------------------------------- phase 23

V2R_BATCH = 64                     # full-width Video2Roll training windows
R2M_BATCH = 16                     # full-width Roll2Midi windows (51 x 100)
AUDEO_STEPS = 5                    # timed Video2Roll steps after a warm-up
R2M_FALL_STEPS = 10                # timed Roll2Midi steps on one batch after
                                   # a warm-up: the reconstruction must fall
AUDEO_STRIPS = 250                 # 10 s of 100 x 900 strips (5 chunks)


def _tf32() -> str:
    import torch

    return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
            f"{torch.backends.cudnn.allow_tf32}")


def _pooled_rel(torch, a: dict, b: dict) -> float:
    return rel_rms(torch.cat([a[k].detach().cpu().flatten() for k in a]),
                   torch.cat([b[k].detach().cpu().flatten() for k in a]))


def _check_close(label: str, got: float, tol: float,
                 what: str = "rel-RMS card vs CPU") -> None:
    log(f"  {label}: {what} {got:.2e} (tol {tol}) "
        f"{'ok' if got <= tol else 'FAIL'}")
    if not got <= tol:
        raise RuntimeError(f"audeo: {label} disagrees")


# a float32 gradient against the card's float64 one, on the card and on the
# CPU, and the card's against the CPU's, per tensor. Through the
# batch-statistics BatchNorms at batch 2, a ReLU or max-pool decision that
# rounding flips moves every gradient upstream of it: Video2Roll's early
# layers read up to 7.1e-3 here on the card, the CPU up to 4.5e-3 and JAX's
# float32 up to 1.09e-2 in tests/test_torch_audeo.py, and which device
# lands closer to float64 depends on the weights. A fault shared by the
# card's float32 and float64 runs reads O(1) against the CPU.
GRAD_MAX = 2e-2


def _float64_copy(torch, model, **kw):
    """A float64 copy of a port model on the card, dropout off, every layer
    computing in float64 (its few float32 output casts round at 1e-7)."""
    from v2ap_torch.ops.layers import Dropout

    copy = type(model)(device="cuda", **kw)
    copy.load_state_dict(model.state_dict())
    copy.double()
    for m in copy.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
        if isinstance(m, Dropout):
            m.rate = 0.0
    return copy


def _exact_grads(torch, model, loss) -> dict:
    model.zero_grad(set_to_none=True)
    loss(model).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _step_card_vs_cpu(torch, label: str, card, cpu, before: dict, lr: float,
                      exact: dict, cpu_grads: dict | None = None) -> None:
    """After one trainer step from the same weights. Gradients, per tensor
    in RMS relative to the float64 gradient's (at least 1e-3 of the
    model's): the card's and the CPU's errors against the float64 gradient,
    and the card against the CPU, each at most GRAD_MAX. ``cpu_grads``
    replaces the CPU model's own gradients (D's, taken at the card's
    fake). Parameters: the card's moved by
    Adam's first update of its own gradients, -lr g / (|g| + 1e-8), within
    1e-6 (Adam maps a gradient to +-lr wherever |g| >> 1e-8, so elements
    whose gradient sits at rounding level move 2 lr apart between card and
    CPU: counted and printed, not compared). Every running statistic per
    tensor within SMALL_REL_RMS."""
    gc = {k: p.grad for k, p in card.named_parameters()}
    gcpu = cpu_grads or {k: p.grad for k, p in cpu.named_parameters()}

    def rms(t):
        return t.double().pow(2).mean().sqrt().item()

    total = rms(torch.cat([g.flatten() for g in exact.values()]))
    worst = {"card": (0.0, ""), "cpu": (0.0, ""), "direct": (0.0, "")}
    bad = []
    for k, g64 in exact.items():
        scale = max(rms(g64), 1e-3 * total)
        g_cpu = gcpu[k].to(g64.device).double()
        err = {"card": rms(gc[k].double() - g64) / scale,
               "cpu": rms(g_cpu - g64) / scale,
               "direct": rms(gc[k].double() - g_cpu) / scale}
        worst = {n: max(worst[n], (e, k)) for n, e in err.items()}
        if not max(err.values()) <= GRAD_MAX:
            bad.append(k)
    log(f"  {label} gradients, worst tensors (tol {GRAD_MAX}): card vs "
        f"float64 {worst['card'][0]:.2e} ({worst['card'][1]}), CPU vs "
        f"float64 {worst['cpu'][0]:.2e} ({worst['cpu'][1]}), card vs CPU "
        f"{worst['direct'][0]:.2e} ({worst['direct'][1]}); pooled card vs "
        f"CPU {_pooled_rel(torch, gc, gcpu):.2e} "
        f"{'ok' if not bad else 'FAIL ' + ', '.join(bad)}")
    if bad:
        raise RuntimeError(f"audeo: {label} gradients disagree")
    moved, flips = 0.0, 0
    cpu_params = dict(cpu.named_parameters())
    for k, p in card.named_parameters():
        g = gc[k].double()
        want = before[k].double() - lr * g / (g.abs() + 1e-8)
        moved = max(moved, (p.double() - want).abs().max().item())
        flips += int(((p.detach().cpu() - cpu_params[k].detach()).abs()
                      > lr / 10).sum())
    log(f"  {label}: parameters vs Adam's update of the card's gradients "
        f"max |err| {moved:.2e} (tol 1e-6); {flips} of "
        f"{sum(p.numel() for p in gc.values())} parameters apart by more "
        f"than lr/10 card vs CPU")
    if not moved <= 1e-6:
        raise RuntimeError(f"audeo: {label} is not Adam's update")
    bufs = dict(cpu.named_buffers())
    if bufs:
        worst = max((rel_rms(b.cpu(), bufs[k]), k)
                    for k, b in card.named_buffers())
        _check_close(f"{label} running statistics (worst tensor, "
                     f"{worst[1]})", worst[0], SMALL_REL_RMS)


def phase_audeo_small(torch) -> None:
    """One Video2RollTrainer step at batch 2 of real 5 x 100 x 900 windows
    and one Roll2MidiTrainer step on 2 x 16 x 24 windows (every dropout
    rate 0), card against CPU from the same weights, f32, TF32 off, each
    gradient also against a float64 copy on the card."""
    import numpy as np

    from v2ap_torch.audeo import (Roll2MidiDiscriminator, Roll2MidiGenerator,
                                  Roll2MidiTrainer, Video2RollTrainer)
    from v2ap_torch.audeo.train import ADV_WEIGHT
    from v2ap_torch.models.video2roll import Video2RollNet
    from v2ap_torch.ops.layers import Dropout

    log(f"  {_tf32()}")
    rng = np.random.default_rng(7)
    frames = rng.random((2, 5, 100, 900)).astype(np.float32)
    labels = (rng.random((2, 51)) > 0.8).astype(np.float32)
    torch.manual_seed(7)       # the same weights whatever ran before
    nets = [Video2RollNet(device=d) for d in ("cuda", "cpu")]
    nets[1].load_state_dict(nets[0].state_dict())
    before = {k: p.detach().clone() for k, p in nets[0].named_parameters()}
    f64, l64 = (torch.from_numpy(a).cuda().double() for a in (frames, labels))
    exact = _exact_grads(
        torch, _float64_copy(torch, nets[0]),
        lambda m: torch.nn.functional.binary_cross_entropy_with_logits(
            m(f64, train=True).double(), l64))
    out = [Video2RollTrainer(n).step(frames, labels) for n in nets]
    _check_close("Video2Roll step loss", rel_rms(out[0][0].cpu(), out[1][0]),
                 SMALL_REL_RMS)
    _check_close("Video2Roll step logits", rel_rms(out[0][1].cpu(),
                                                   out[1][1]), SMALL_REL_RMS)
    _step_card_vs_cpu(torch, "Video2Roll step", *nets, before, 1e-3, exact)

    roll = rng.random((2, 16, 24, 1)).astype(np.float32)
    gt = (roll > 0.7).astype(np.float32)
    pairs = []
    for dev in ("cuda", "cpu"):
        gen = Roll2MidiGenerator(device=dev)
        for m in gen.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        pairs.append((gen, Roll2MidiDiscriminator(height=16, width=24,
                                                  device=dev)))
    for a, b in zip(pairs[0], pairs[1]):
        b.load_state_dict(a.state_dict())
    before = [{k: p.detach().clone() for k, p in m.named_parameters()}
              for m in pairs[0]]
    g64 = _float64_copy(torch, pairs[0][0])
    d64 = _float64_copy(torch, pairs[0][1], height=16, width=24)
    r64, gt64 = (torch.from_numpy(a).cuda().double() for a in (roll, gt))

    def g_loss(g):
        fake = g(r64, train=True).double()
        return (ADV_WEIGHT * (d64(fake) - 1.0).pow(2).mean()
                + (1 - ADV_WEIGHT) * (fake - gt64).pow(2).mean())

    g_exact = _exact_grads(torch, g64, g_loss)
    d_cpu = Roll2MidiDiscriminator(height=16, width=24, device="cpu")
    d_cpu.load_state_dict(pairs[1][1].state_dict())
    losses = [Roll2MidiTrainer(g, d).step(roll, gt) for g, d in pairs]
    # D's step reads each device's updated G, which Adam's +-lr moves apart:
    # its float64 and CPU references take the card's updated G's fake
    with torch.no_grad():
        fake = pairs[0][0](torch.from_numpy(roll).cuda())
    fake64 = fake.double()

    def d_loss(d):
        return 0.5 * ((d(gt64) - 1.0).pow(2).mean() + d(fake64).pow(2).mean())

    d_exact = _exact_grads(torch, d64, d_loss)
    gt_cpu, fake_cpu = torch.from_numpy(gt), fake.cpu()
    (0.5 * ((d_cpu(gt_cpu) - 1.0).pow(2).mean()
            + d_cpu(fake_cpu).pow(2).mean())).backward()
    d_cpu_grads = {k: p.grad for k, p in d_cpu.named_parameters()}
    g_terms = [0, 2, 3]
    _check_close("Roll2Midi step G, adversarial and reconstruction losses",
                 rel_rms(torch.tensor(losses[0])[g_terms],
                         torch.tensor(losses[1])[g_terms]), SMALL_REL_RMS)
    with torch.no_grad():
        want = d_loss(d64).item()   # d64 still holds the initial D
    _check_close(f"Roll2Midi step D loss (card {losses[0][1]:.6f}, CPU "
                 f"{losses[1][1]:.6f}) vs float64 at the card's updated G",
                 abs(losses[0][1] - want) / abs(want), SMALL_REL_RMS,
                 "relative error")
    _step_card_vs_cpu(torch, "Roll2Midi step, G", pairs[0][0], pairs[1][0],
                      before[0], 5e-4, g_exact)
    _step_card_vs_cpu(torch, "Roll2Midi step, D", pairs[0][1], pairs[1][1],
                      before[1], 1e-3, d_exact, d_cpu_grads)


def _timed_steps(torch, label: str, step, steps: int, windows: int) -> list:
    """One warm-up ``step()``, then ``steps`` timed ones (synchronised).
    Prints every time, the median, windows per second and peak memory.
    Returns every step's result, the warm-up's first."""
    import numpy as np

    t0 = time.perf_counter()
    results = [step()]
    torch.cuda.synchronize()
    log(f"  {label}: warm-up step {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    log(f"  {label} x{steps} ({_tf32()}): step (s) "
        f"{', '.join(f'{t:.4f}' for t in times)}; median {med:.4f} s, "
        f"{windows / med:.1f} windows/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return results


def phase_audeo(torch) -> None:
    """Phase 23 (see the module docstring)."""
    import numpy as np

    from v2ap_torch.audeo import (MidiSynth, Roll2MidiDiscriminator,
                                  Roll2MidiGenerator, Roll2MidiTrainer,
                                  Video2RollTrainer, evaluate_rolls,
                                  roll_to_notes, video2roll_infer_chunks,
                                  write_midi_file)
    from v2ap_torch.audeo.datasets import roll2midi_infer
    from v2ap_torch.models.video2roll import Video2RollNet

    phase_audeo_small(torch)
    gen = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.rand(V2R_BATCH, 5, 100, 900, generator=gen, device="cuda")
    labels = (torch.rand(V2R_BATCH, 51, generator=gen, device="cuda")
              > 0.8).float()
    torch.manual_seed(0)
    net = Video2RollNet(device="cuda")
    trainer = Video2RollTrainer(net)
    losses = _timed_steps(torch, f"Video2Roll train step, batch {V2R_BATCH} "
                          f"x 5 x 100 x 900", lambda: trainer.step(
                              frames, labels)[0], AUDEO_STEPS, V2R_BATCH)
    if not all(torch.isfinite(x).item() for x in losses):
        raise RuntimeError("audeo: non-finite Video2Roll loss")
    log(f"  Video2Roll losses {', '.join(f'{x.item():.4f}' for x in losses)}")
    del frames, labels, trainer

    rng = np.random.default_rng(9)
    roll = rng.random((R2M_BATCH, 51, 100, 1)).astype(np.float32)
    gt = (roll > 0.7).astype(np.float32)
    gens = {}
    for enhance in (False, True):
        name = "enhance" if enhance else "plain"
        g = Roll2MidiGenerator(enhance=enhance, device="cuda")
        tr = Roll2MidiTrainer(g, Roll2MidiDiscriminator(device="cuda"))
        out = _timed_steps(torch, f"Roll2Midi {name} G + D step, batch "
                           f"{R2M_BATCH} x 51 x 100", lambda: tr.step(
                               roll, gt), R2M_FALL_STEPS, R2M_BATCH)
        recs = [o[3] for o in out]
        log(f"  Roll2Midi {name}: reconstruction loss over the warm-up and "
            f"{R2M_FALL_STEPS} steps on one batch "
            + ", ".join(f"{r:.5f}" for r in recs))
        if not (np.isfinite([x for o in out for x in o]).all()
                and recs[-1] < recs[0]):
            raise RuntimeError(f"audeo: Roll2Midi {name} reconstruction did "
                               f"not fall ({recs[0]:.5f} -> {recs[-1]:.5f})")
        gens[name] = g

    strips = np.random.default_rng(10).random(
        (AUDEO_STRIPS, 100, 900)).astype(np.float32)
    gt_roll = (np.random.default_rng(11).random((AUDEO_STRIPS, 88)) > 0.9
               ).astype(np.int64)
    net.eval()
    walls = {}
    root = tempfile.mkdtemp(prefix="v2ap_chip_smoke_audeo_")
    try:
        t0 = time.perf_counter()
        chunks = video2roll_infer_chunks(net, strips,
                                         out_dir=os.path.join(root, "roll"))
        walls["video2roll_infer_chunks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        midi = roll2midi_infer(gens["plain"], [c[2] for c in chunks],
                               out_dir=os.path.join(root, "midi"))
        walls["roll2midi_infer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        synth = MidiSynth()
        cleaned = synth.rolls_from_npz_dir(os.path.join(root, "midi"),
                                           key="midi")
        audio = synth.synthesize_roll(cleaned, min_key=0)
        walls["MidiSynth"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = os.path.join(root, "clean.mid")
        write_midi_file(path, roll_to_notes(cleaned, min_key=0))
        walls["write_midi_file"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        metrics = evaluate_rolls(cleaned, gt_roll[: len(cleaned)])
        walls["evaluate_rolls"] = time.perf_counter() - t0
        n_files = (len(os.listdir(os.path.join(root, "roll"))),
                   len(os.listdir(os.path.join(root, "midi"))))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rolls = np.concatenate([c[3] for c in chunks])
    logits = np.concatenate([c[2] for c in chunks])
    ok = (len(chunks) == 5 and n_files == (5, 4) and len(midi) == 4
          and np.isfinite(logits).all() and np.isfinite(audio).all()
          and set(np.unique(rolls)) <= {0, 1}
          and set(np.unique(cleaned)) <= {0, 1}
          and data[:4] == b"MThd" and data[14:18] == b"MTrk"
          and all(np.isfinite(v) for v in metrics.as_dict().values()))
    log(f"  Audeo offline path over {AUDEO_STRIPS} strips: {len(chunks)} "
        f"roll chunks, {len(midi)} midi chunks (the odd last dropped), files "
        f"{n_files}, roll on {rolls.mean():.3f}, cleaned on "
        f"{cleaned.mean():.3f}, audio {audio.shape} finite, MIDI "
        f"{len(data)} bytes; metrics {metrics.as_dict()}; walls (s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))
    if not ok:
        raise RuntimeError("audeo: the offline path's outputs are wrong")


# ------------------------------------------------------------------ main

# -------------------------------------------------------------- phase 24

WEIGHTS_SEED = 24                  # the seeded "published" tensors
INT8_RUNS = 1                      # timed int8 and bf16 V2A generates each
INT8_MIXED_RUNS = 1                # timed mixed generates in each mode
INT8_ROWS = 2 * 257                # int8 Linear card vs CPU: two frames'
                                   # tokens through ViT-bigG's fc1
BIGG_SHARDS = 3                    # model-0000i-of-00003.safetensors
# cuBLASLt's int8 tensor-core GEMMs (int8 in, int32 accumulated), e.g.
# cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16 (the mma.sync
# m16n8k32 int8 shape; read in a trace on the card)
INT8_GEMM = ("gemm_s8", "i16832gemm", "imma", "s8s8", "i8i8")
# a product off the tensor cores: cuBLAS's matrix-vector and small-k kernels
CUDA_CORE_GEMM = ("gemv", "gemmk1", "dot_kernel", "gemmSN")
ENCODERS = {                       # flag -> (golden name, file, dtype)
    "clip": ("clip_bigg", "sharded safetensors", "float16"),
    "t5": ("t5_large", "pytorch_model.bin", "float32"),
    "encodec": ("encodec_24khz", "pytorch_model.bin", "float32"),
    "dinov2": ("dinov2_giant", "pytorch_model.bin", "bfloat16"),
    "convnext": ("convnext_xxlarge", "pytorch_model.bin", "bfloat16"),
}


def golden_layout(name: str) -> dict:
    """{"state": {key: shape}, ...} of a published checkpoint at full
    width (``tests/golden/hf_keys_<name>.json``)."""
    with open(os.path.join(ROOT, "tests", "golden",
                           f"hf_keys_{name}.json")) as f:
        return json.load(f)


def seeded_state(torch, shapes: dict, seed: int, dtype) -> dict:
    """Seeded tensors of ``shapes`` in ``dtype`` on the host, drawn on the
    card: matrices and kernels N(0, 1 / fan_in), norm scales, weight-norm
    magnitudes and layer scales 1 + 0.02 N, running variances |N| + 0.5,
    other vectors 0.02 N; BatchNorm counters 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    unit = ("norm.weight", "norm1.weight", "norm2.weight", "layrnorm.weight",
            "layer_norm.weight", "layer_norm1.weight", "layer_norm2.weight",
            "weight_g", "lambda1", "layer_scale_parameter")
    out = {}
    for key, shape in shapes.items():
        shape = tuple(shape)
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        x = torch.randn(shape, generator=gen, device="cuda")
        if key.endswith(unit) or (".bn" in key and key.endswith(".weight")
                                  and len(shape) == 1):
            x = 1.0 + 0.02 * x
        elif key.endswith("running_var"):
            x = x.abs() + 0.5
        elif len(shape) >= 2:
            x = x / math.sqrt(math.prod(shape[1:]))
        else:
            x = 0.02 * x
        out[key] = x.to(dtype).cpu()
    return out


def write_safetensors(torch, path: str, tensors: dict) -> None:
    """A minimal safetensors writer: the 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw buffers."""
    import struct

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64"}
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def write_snapshot(torch, root: str, flag: str, sd: dict) -> str:
    """``sd`` as a snapshot directory under ``root``: ViT-bigG as sharded
    ``model-*.safetensors`` with its index, the others as
    ``pytorch_model.bin``."""
    path = os.path.join(root, flag)
    os.makedirs(path, exist_ok=True)
    if flag != "clip":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        return path
    keys = list(sd)
    per = math.ceil(len(keys) / BIGG_SHARDS)
    weight_map = {}
    for i in range(BIGG_SHARDS):
        name = f"model-{i + 1:05d}-of-{BIGG_SHARDS:05d}.safetensors"
        part = {k: sd[k] for k in keys[i * per:(i + 1) * per]}
        write_safetensors(torch, os.path.join(path, name), part)
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(
            t.numel() * t.element_size() for t in sd.values())},
            "weight_map": weight_map}, f)
    return path


def _same_tensors(torch, label: str, got, want) -> int:
    """Every tensor of module ``got`` bit-equal to module ``want``'s in
    ``got``'s dtype; returns the count."""
    ref = want.state_dict()
    bad = [k for k, t in got.state_dict().items()
           if not torch.equal(t.cpu(), ref[k].to(t.dtype))]
    if bad:
        raise RuntimeError(f"weights in: {label} differs from the in-process "
                           f"reader at {bad[:5]}")
    return len(ref)


def phase_weights_in(torch, frames, root: str):
    """Phase 24a. Seeded tensors under the published key layouts, written
    as snapshots; ``python -m v2ap_torch.convert`` as its own process; the
    pipeline's ``load_weights``; every loaded tensor against the
    in-process readers; a V2A generate. Its walls are not taken: phase
    26b's processes share the card and the host with it. Returns (the
    converted directory, the mixed configuration, what phase 24b takes
    over: the V2A pipeline under ``pipe``)."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.convert import build_encoder
    from v2ap_torch.models.clip_vit import CLIPVisionModel, clip_vit_l_336
    from v2ap_torch.models.video2roll import Video2RollNet
    from v2ap_torch.predict import Predictor
    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.jitting import create_model_zeros
    from v2ap_torch.utils.torch_convert import (load_clip_vision_state_dict,
                                                load_video2roll_state_dict,
                                                read_snapshot)

    snaps = os.path.join(root, "snapshots")
    out = os.path.join(root, "converted")
    dirs, sizes = {}, {}
    for i, (flag, (name, kind, dtype)) in enumerate(ENCODERS.items()):
        sd = seeded_state(torch, golden_layout(name)["state"],
                          WEIGHTS_SEED + i, getattr(torch, dtype))
        sizes[flag] = sum(t.numel() * t.element_size() for t in sd.values())
        dirs[flag] = write_snapshot(torch, snaps, flag, sd)
        log(f"  {flag}: {len(sd)} keys ({name}), "
            f"{sum(t.numel() for t in sd.values()) / 1e6:.1f} M values, "
            f"{dtype}, {sizes[flag] / 2**30:.2f} GiB as {kind}")
        del sd
    extra = {}
    for name, dtype, i in (("clip_l336", torch.float16, 10),
                           ("video2roll", torch.float32, 11)):
        sd = seeded_state(torch, golden_layout(name)["state"],
                          WEIGHTS_SEED + i, dtype)
        path = os.path.join(snaps, name)
        os.makedirs(path, exist_ok=True)
        if name == "clip_l336":
            write_safetensors(torch, os.path.join(path, "model.safetensors"),
                              sd)
        else:
            torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        extra[name] = path
        del sd

    args = ["v2ap_torch.convert", "--out", out]
    for flag, path in dirs.items():
        args += [f"--{flag}", path]
    stdout = []
    run_cli(args, "convert", out=stdout, wall_shown=False)
    per_flag = [line for line in stdout[0].splitlines()
                if line.startswith("converted ")]
    for line in per_flag:
        log(f"    {line}")
    if len(per_flag) != len(dirs) or any(
            "; 0 keys not used" not in line for line in per_flag):
        raise RuntimeError(f"convert: a flag did not convert or left keys: "
                           f"{per_flag}")
    # ViT-L/336 has no flag: the reader in process, save_model under the
    # tower's name (what load_weights reads)
    clip_l = create_model_zeros(
        lambda d: CLIPVisionModel(clip_vit_l_336(), device=d))
    if load_clip_vision_state_dict(read_snapshot(extra["clip_l336"]), clip_l):
        raise RuntimeError("weights in: ViT-L/336 left keys")
    save_model(os.path.join(out, "clip_vit2"), clip_l)
    log("  ViT-L/336 (single model.safetensors) read and saved")

    base = C.v2a_default()
    cfg = base.replace(conditioning=dataclasses.replace(
        base.conditioning, frame_stride=1, feature_cache=False))
    pred = Predictor(cfg=cfg, device="cuda")
    pred.setup()
    pipe = pred.pipeline
    loaded = pipe.load_weights(out)
    log(f"  V2A pipeline built; load_weights -> {loaded}")
    if sorted(loaded) != ["clip", "encodec", "t5"]:
        raise RuntimeError(f"weights in: load_weights loaded {loaded}")
    n = 0
    for flag, module in (("clip", pipe.clip), ("t5", pipe.t5),
                         ("encodec", pipe.codec)):
        want, reader = build_encoder(flag)
        if reader(read_snapshot(dirs[flag]), want):
            raise RuntimeError(f"weights in: {flag} left keys")
        n += _same_tensors(torch, flag, module, want)
        del want
    v2r = create_model_zeros(lambda d: Video2RollNet(num_classes=51,
                                                     device=d))
    if load_video2roll_state_dict(read_snapshot(extra["video2roll"]), v2r):
        raise RuntimeError("weights in: Video2Roll left keys")
    pipe.cfm.video2roll.load_state_dict(v2r.state_dict())
    n += _same_tensors(torch, "video2roll", pipe.cfm.video2roll, v2r)
    log(f"  {n} tensors of ViT-bigG, FLAN-T5, EnCodec and Video2Roll "
        f"bit-equal to the in-process readers' (in the pipeline's dtypes)")
    # EnCodec's weight norm folded on the host against torch's on the card
    sd = torch.load(os.path.join(dirs["encodec"], "pytorch_model.bin"),
                    weights_only=True)
    worst = 0.0
    for layer, key in ((pipe.codec.encoder.layers[0], "encoder.layers.0"),
                       (pipe.codec.decoder.layers[3], "decoder.layers.3")):
        v = sd[f"{key}.conv.weight_v"].cuda()
        g = sd[f"{key}.conv.weight_g"].cuda()
        ref = torch._weight_norm(v, g, 0)
        worst = max(worst, (layer.weight - ref).abs().max().item()
                    / ref.abs().max().item())
    log(f"  EnCodec's folded weight_g / weight_v (a convolution and a "
        f"transposed one) against torch._weight_norm on the card: max "
        f"|diff| / max|w| {worst:.2e} (tol 1e-6)")
    if not worst <= 1e-6:
        raise RuntimeError("weights in: EnCodec's weight norm disagrees")
    x = torch.rand(4, 5, 100, 900, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    with torch.inference_mode():
        logits = pipe.cfm.video2roll(x)
    wav, sr = pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                            frames_cache=[(frames, CLIP_S, 1)])
    log(f"  V2A generate on the loaded weights: {wav.shape[0]} samples, "
        f"finite {bool(np.isfinite(wav).all())}, rms "
        f"{float(np.sqrt(np.mean(wav.astype(np.float64) ** 2))):.4f}; the "
        f"loaded Video2Roll's logits on 4 windows finite "
        f"{bool(logits.isfinite().all())}")
    if wav.shape[0] != int(CLIP_S * sr) or not np.isfinite(wav).all() or \
            not logits.isfinite().all():
        raise RuntimeError("weights in: the generate on loaded weights failed")

    # the other towers: a mixed pipeline through Predictor.setup(ckpt=)
    mixed = base.replace(
        model=dataclasses.replace(base.model, dim_text_raw=4608),
        conditioning=dataclasses.replace(base.conditioning,
                                         video_encoder="mixed",
                                         frame_stride=1, feature_cache=False))
    return out, mixed, {"pipe": pipe, "dirs": dirs, "clip_l": clip_l}


def check_mixed_weights(torch, pipe, held: dict) -> None:
    """The mixed pipeline's towers against the in-process readers."""
    from v2ap_torch.convert import build_encoder
    from v2ap_torch.utils.torch_convert import read_snapshot

    t0 = time.perf_counter()
    towers = {t.name: t.model for t in pipe.towers}
    n = _same_tensors(torch, "clip_vit2", towers["clip_vit2"],
                      held.pop("clip_l"))
    for flag, name in (("dinov2", "dinov2"), ("convnext", "clip_convnext"),
                       ("clip", "clip_vit")):
        want, reader = build_encoder(flag)
        reader(read_snapshot(held["dirs"][flag]), want)
        n += _same_tensors(torch, name, towers[name], want)
        del want
    log(f"  mixed pipeline from Predictor(...).setup(ckpt=): {n} tensors of "
        f"ViT-bigG, ViT-L/336, ConvNeXt-XXLarge (trunk) and DINOv2-giant "
        f"(positions resized 37x37 -> 16x16) bit-equal to the in-process "
        f"readers' in {time.perf_counter() - t0:.2f} s")


def int8_linear_card_vs_cpu(torch) -> None:
    """One int8 ``Linear`` at ViT-bigG's fc1 (1664 -> 8192) on INT8_ROWS
    bf16 tokens, on the card and on the CPU: equal codes and scales, equal
    int32 sums, the output within one bf16 ulp; the int8 product timed
    beside bf16 ``F.linear`` (CUDA events)."""
    import torch.nn.functional as F

    from v2ap_torch.utils.quantize import (int8_linear, int8_matmul,
                                           quantize_rows)

    g = torch.Generator(device="cuda").manual_seed(240)
    x = torch.randn(INT8_ROWS, 1664, generator=g, device="cuda"
                    ).to(torch.bfloat16)
    w = (torch.randn(8192, 1664, generator=g, device="cuda") / 40.8
         ).to(torch.bfloat16)
    b = (torch.randn(8192, generator=g, device="cuda") * 0.02
         ).to(torch.bfloat16)
    qx, sx = quantize_rows(x)
    qw, sw = quantize_rows(w)
    qxc, sxc = quantize_rows(x.cpu())
    qwc, swc = quantize_rows(w.cpu())
    codes = (torch.equal(qx.cpu(), qxc) and torch.equal(qw.cpu(), qwc)
             and torch.equal(sx.cpu(), sxc) and torch.equal(sw.cpu(), swc))
    acc = int8_matmul(qx, qw)
    sums = torch.equal(acc.cpu(), int8_matmul(qxc, qwc))
    y = int8_linear(x, w, b).float().cpu()
    yc = int8_linear(x.cpu(), w.cpu(), b.cpu()).float()
    ulp = torch.exp2(torch.floor(torch.log2(yc.abs().clamp_min(2.0 ** -126)))
                     - 7)
    over = int(((y - yc).abs() > ulp).sum())
    differ = int((y != yc).sum())
    big = torch.randn(64 * 257, 1664, generator=g, device="cuda"
                      ).to(torch.bfloat16)
    ms_int8 = time_ms(torch, lambda: int8_linear(big, w, b))
    qb, _ = quantize_rows(big)
    ms_mm = time_ms(torch, lambda: int8_matmul(qb, qw))
    ms_bf16 = time_ms(torch, lambda: F.linear(big, w, b))
    log(f"  int8 Linear ({INT8_ROWS}, 1664) -> 8192 card vs CPU: codes and "
        f"scales equal {codes}, int32 sums equal {sums}, outputs differing "
        f"{differ} (more than one bf16 ulp: {over})")
    log(f"  at a 64-frame chunk's (16448, 1664) -> 8192: int8 Linear "
        f"(quantize, torch._int_mm, dequantize) {ms_int8:.4f} ms, its "
        f"torch._int_mm alone {ms_mm:.4f} ms, bf16 F.linear {ms_bf16:.4f} ms "
        f"(CUDA events, 20 calls)")
    if not codes or not sums or over:
        raise RuntimeError("int8 Linear: card and CPU disagree")


def profile_int8_tower(torch, pipe, frames) -> None:
    """The int8 tower's kernels over one 64-frame chunk under the
    profiler: an int8 tensor-core GEMM (cuBLASLt, int32 sums) for each of
    the 289 ``Linear`` calls, no product off the tensor cores."""
    from torch.profiler import ProfilerActivity, profile

    px = torch.from_numpy(frames[:64]).cuda()
    tower = pipe.towers[0]
    from v2ap_torch.models.clip_vit import device_normalize

    def run():
        with torch.inference_mode():
            tower.model(device_normalize(tower.preprocess(px), tower.mean,
                                         tower.std))
    run()
    pad = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace can miss the first kernels after it starts (runs read
        # 288 GEMMs of 289, once with 32 of these before them and the
        # first Linear's two Q1 lost too): small ones go first
        for _ in range(256):
            pad.add_(1.0)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    total = sum(e.device_time_total for e in rows)
    if not total:
        raise RuntimeError("int8 tower profile: no device time recorded")
    int8 = [e for e in rows if any(s in e.key for s in INT8_GEMM)]
    slow = [e.key for e in rows if any(s in e.key for s in CUDA_CORE_GEMM)]
    n_int8 = sum(e.count for e in int8)
    linears = 6 * pipe.clip_cfg.num_layers + 1
    log(f"  int8 ViT-bigG, one 64-frame chunk: {total / 1e3:.2f} ms of "
        f"kernels; int8 GEMM launches {n_int8} for {linears} Linear calls, "
        f"{sum(e.device_time_total for e in int8) / 1e3:.2f} ms")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:10]:
        log(f"    {e.device_time_total / 1e3:8.2f} ms {e.count:5d}x "
            f"{e.device_time_total / total:6.1%}  {e.key[:100]}")
    if n_int8 < linears or slow:
        raise RuntimeError(f"int8 tower: int8 GEMMs {n_int8} < {linears} or "
                           f"products off the tensor cores {slow[:3]}")


def phase_int8(torch, frames, out: str, mixed_cfg, held: dict,
               root: str) -> dict:
    """Phase 24b and 24c (the V2A pipeline taken from ``held``). Returns
    the launch counts of the profiled int8-tower generate."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.ops.layers import Linear
    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.predict import Predictor

    pipe = held.pop("pipe")
    if not pipe.quantize_towers or any(
            not m.int8 for m in pipe.clip.modules() if isinstance(m, Linear)):
        raise RuntimeError("int8: the default (no V2AP_INT8_TOWERS, no gate "
                           "file) did not serve int8 towers")
    int8_linear_card_vs_cpu(torch)

    def gen():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    res = {}
    for label, on in (("int8 towers", True), ("bf16 towers", False),
                      ("int8 towers again", True)):
        pipe.set_int8_towers(on)
        res[label] = phase_generate(torch, pipe, f"V2A generate, {label}",
                                    gen, generate_expect(pipe, len(frames)),
                                    runs=INT8_RUNS)
    with torch.inference_mode():
        feats = {}
        for on in (True, False):
            pipe.set_int8_towers(on)
            feats[on], _ = pipe.encode_video_frames_clip(
                None, 768, frames_cache=[(frames, CLIP_S, 1)])
    pipe.set_int8_towers(True)
    drift = rel_rms(feats[True].float(), feats[False].float())
    i8, bf = res["int8 towers"], res["bf16 towers"]
    log(f"  int8 against bf16 towers (same weights, same run): "
        f"video_encode_s {i8['stages']['video_encode_s']:.4f} / "
        f"{res['int8 towers again']['stages']['video_encode_s']:.4f} vs "
        f"{bf['stages']['video_encode_s']:.4f} s, wall {i8['wall']:.4f} / "
        f"{res['int8 towers again']['wall']:.4f} vs {bf['wall']:.4f} s; "
        f"ViT-bigG features int8 vs bf16 rel-RMS {drift:.4e}")
    if not 0.0 < drift < 0.5:
        raise RuntimeError(f"int8: feature drift {drift} against bf16")
    profile_int8_tower(torch, pipe, frames)
    int8_counts = phase_profile(torch, "int8-tower generate", lambda: gen(),
                                SM90_FWD, generate_expect(pipe, len(frames)),
                                k1_expect(pipe))
    sample_bf16 = bf["stages"]["sample_s"]
    del pipe
    torch.cuda.empty_cache()

    from v2ap_torch.scripts import probe_tower_drift

    log("  probe_tower_drift (ViT-bigG, 64 frames, f32 / bf16 / int8 "
        "variants; tower seconds a 64-frame chunk, median of 3):")
    probe = probe_tower_drift.main(["--frames", "64", "--reps", "3"])
    torch.cuda.empty_cache()
    if probe["int8_linears"] != 289 or not all(
            math.isfinite(v) for v in probe.values()):
        raise RuntimeError(f"probe_tower_drift: {probe}")

    t0 = time.perf_counter()
    pred = Predictor(cfg=mixed_cfg, device="cuda")
    pred.setup(ckpt=out)
    torch.cuda.synchronize()
    log(f"  Predictor(mixed).setup(ckpt=...): {time.perf_counter() - t0:.2f} "
        f"s, towers int8 {pred.pipeline.quantize_towers}")
    check_mixed_weights(torch, pred.pipeline, held)
    stats = {}
    for label, on in (("int8", True), ("bf16", False)):
        pred.pipeline.set_int8_towers(on)
        stats[label] = {}
        tower_generate(torch, pred.pipeline, frames, f"mixed, {label} towers",
                       (48 + 24) * TOWER_CHUNKS, INT8_MIXED_RUNS,
                       stats[label])
    log(f"  mixed int8 against bf16 towers: wall {stats['int8']['wall']:.4f} "
        f"vs {stats['bf16']['wall']:.4f} s, video_encode_s "
        f"{stats['int8']['video_encode_s']:.4f} vs "
        f"{stats['bf16']['video_encode_s']:.4f} s")
    del pred
    torch.cuda.empty_cache()

    base = mixed_cfg.replace(
        model=dataclasses.replace(mixed_cfg.model, dim_text_raw=None),
        conditioning=dataclasses.replace(mixed_cfg.conditioning,
                                         video_encoder="clip_vit"))
    os.environ["V2AP_INT8_CFM"] = "1"
    try:
        pipe = V2APipeline(base, seed=0, device="cuda")
    finally:
        del os.environ["V2AP_INT8_CFM"]
    n_lin = sum(1 for m in pipe.cfm.modules() if isinstance(m, Linear))
    n_int8 = sum(1 for m in pipe.cfm.modules()
                 if isinstance(m, Linear) and m.int8)
    log(f"  V2AP_INT8_CFM=1: {n_int8} of the CFM's {n_lin} Linear layers "
        f"int8 (Video2Roll's included); roll tag {pipe._roll_tag!r}")
    if n_int8 != n_lin or not pipe.quantize_cfm:
        raise RuntimeError("int8 CFM: not every Linear is int8")
    from v2ap_torch import config as C

    x0, text, roll, ctx, cmask, mask = sampler_inputs(torch, pipe, frames)
    cfg25 = C.SamplerConfig(steps=25, cfg_strength=2.0)
    first = pipe._sample(x0, text, roll, ctx, cmask, mask, cfg25)
    reset_launch_counts()
    again = pipe._sample(x0, text, roll, ctx, cmask, mask, cfg25)
    replayed = {k: launch_counts[k] for k in int8_expect(0)}
    reset_launch_counts()
    with torch.inference_mode():
        want = pipe.cfm.sample(x0, text_embed=text, frames_embed=roll,
                               context=ctx, context_mask=cmask, mask=mask,
                               sampler=cfg25)
    sampler_q2 = launch_counts["int8_dequantize"]
    same = torch.equal(first, want) and torch.equal(again, want)
    log(f"  int8 CFM: captured sampler vs eager bit-equal {same} (max |diff| "
        f"{(again - want).abs().max().item():.3e}); Q1, Q2 launches of a "
        f"replay {replayed}, of the eager sampler {int8_expect(sampler_q2)}")
    if not same or not torch.isfinite(want).all():
        raise RuntimeError("int8 CFM: the captured sampler differs from the "
                           "eager one")
    if not sampler_q2 or replayed != int8_expect(sampler_q2):
        raise RuntimeError("int8 CFM: a replay does not count the eager "
                           "sampler's Q1 and Q2 launches")

    def gen_c():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    expect = generate_expect(pipe, len(frames))
    for key, n in int8_expect(sampler_q2).items():
        expect[key] += n
    r = phase_generate(torch, pipe, "V2A generate, int8 CFM and towers",
                       gen_c, expect, runs=INT8_RUNS)
    log(f"  sample_s int8 CFM {r['stages']['sample_s']:.4f} s vs bf16 CFM "
        f"{sample_bf16:.4f} s (the int8-tower generates above)")
    del pipe
    torch.cuda.empty_cache()

    log("[24c/27] python -m v2ap_torch.int8_tower_gate --tiny")
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    for i in range(2):                   # FAD needs two clips a set
        with open(os.path.join(clips, f"clip{i}.mp4"), "wb") as f:
            f.write(np.random.default_rng(i).bytes(4096))  # no cv2 here
    gate = os.path.join(root, "int8_gate.json")
    run_cli(["v2ap_torch.int8_tower_gate", "--videos", clips, "--tiny",
             "--steps", "2"], "int8 gate", env={"V2AP_INT8_GATE_FILE": gate})
    with open(gate) as f:
        verdict = json.load(f)
    log(f"  verdict file {verdict}: plumbing only (seeded Cnn14, tiny "
        f"stack, and the clips do not decode here, so both variants "
        f"are unconditioned)")
    if verdict.get("clips") != 2 or not math.isfinite(
            verdict.get("fad_int8_vs_bf16", math.nan)):
        raise RuntimeError(f"int8 gate: verdict {verdict}")
    return int8_counts


def phase_24(torch, frames, after_24a=None) -> dict:
    """Phase 24; ``after_24a()`` runs between 24a and 24b (phase 26b's
    background processes end there: 24b's profiles count kernels in the
    card's trace). Returns the launch counts of 24b's profiled int8-tower
    generate."""
    root = tempfile.mkdtemp(prefix="v2ap_chip_smoke_")
    os.environ.pop("V2AP_INT8_TOWERS", None)
    os.environ["V2AP_INT8_GATE_FILE"] = os.path.join(root, "none.json")
    try:
        out, mixed, held = phase_weights_in(torch, frames, root)
        if after_24a is not None:
            after_24a()
        log("[24b/27] int8: the Linear card vs CPU; int8 vs bf16 towers; the "
            "tower's profile; drift; mixed towers; V2AP_INT8_CFM=1")
        t0 = time.perf_counter()
        int8_counts = phase_int8(torch, frames, out, mixed, held, root)
        log(f"  phases 24b-c: {time.perf_counter() - t0:.2f} s")
    finally:
        del os.environ["V2AP_INT8_GATE_FILE"]
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return int8_counts


# --------------------------------------------------------------- phase 25

AUDIOLDM_RUNS = 3                  # timed full-width text_to_audio calls
AUDIOLDM_STEPS = 25
AUDIOLDM_GUIDANCE = 2.5
AUDIOLDM_PROMPTS = ("a dog barks while rain falls on a tin roof",
                    "a steam train passes a level crossing")
AUDIOLDM_SAMPLES = 160 * 1024 + 32  # HiFi-GAN's length for 1024 mel frames
VOCOS_FRAMES = 938                 # 10 s of 24 kHz mel at hop 256
VOCOS_REPS = 5
VOCOS_REL_RMS = 1e-4
VAE_VOCODER_LATENTS = (2, 750, 128)
VAE_VOCODER_REPS = 3
PRED_BATCH = 8
PRED_STEPS = 5                     # timed predictor train steps
PRED_FWD_REPS = 5
PRED_TEXTS = ("a dog barks", "rain on a tin roof", "a steam train",
              "footsteps on gravel", "a door slams", "wind in the trees",
              "a kettle whistles", "applause")


def fill_zero_params(torch, model, seed: int, std: float = 0.02) -> int:
    """Seeded normal values into every parameter that is all zero (the
    zero-initialised convolutions, projections and gates), so that each
    layer takes part; returns how many were filled."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n = 0
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point() and not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * std)
                n += 1
    return n


def ldm_small_backend(torch, device: str):
    """The small AudioLDM stack of the card-vs-CPU check: a two-level UNet
    (32 channels), tiny CLAP, VAE and HiFi-GAN, f32."""
    from v2ap_torch.models import audioldm_vae, clap, hifigan
    from v2ap_torch.models import latent_diffusion as ldm
    from v2ap_torch.utils.device import seeded_init

    a_cfg, t_cfg = clap.clap_tiny_test()
    cfg = ldm.LDMConfig(in_channels=4, out_channels=4, model_channels=32,
                        num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), num_head_channels=16,
                        film_dim=a_cfg.projection_dim, timesteps=100,
                        latent_t=32, latent_f=16)
    dev = torch.device(device)
    with seeded_init(3, dev):
        return ldm.AudioLDMBackend(
            cfg, clap=clap.ClapModel(a_cfg, t_cfg, device=dev),
            vae=audioldm_vae.AudioLDMVAE(audioldm_vae.AudioLDMVAEConfig(
                mel_bins=32, base_channels=32, channel_mults=(1, 2),
                num_res_blocks=1, latent_channels=4, groups=8), device=dev),
            vocoder=hifigan.HiFiGANGenerator(hifigan.HiFiGANConfig(
                in_channels=32, upsample_initial_channel=64,
                upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                resblock_kernel_sizes=(3, 5),
                resblock_dilations=((1, 3), (1, 3))), device=dev),
            device=dev)


def audioldm_stages(torch, backend, ids, mask, u_ids, u_mask, x_t,
                    noise=None, eta: float = 0.0,
                    steps: int = AUDIOLDM_STEPS) -> tuple:
    """``text_to_audio``'s stages one by one, each synchronised and timed:
    (latents, waveform, {stage: seconds})."""
    sec = {}

    def sync():
        if x_t.is_cuda:
            torch.cuda.synchronize()

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        sec[name] = time.perf_counter() - t0
        return out

    with torch.no_grad():
        film, film_u = timed("clap", lambda: (
            backend.clap.get_text_features(ids, mask),
            backend.clap.get_text_features(u_ids, u_mask)))
        z = timed("ddim", lambda: backend.ldm.ddim_sample(
            x_t, film=film, film_uncond=film_u.expand_as(film), steps=steps,
            guidance_scale=AUDIOLDM_GUIDANCE, eta=eta, noise=noise))
        mel = timed("vae_decode", lambda: backend.vae.decode(
            z / backend.ldm.cfg.scale_factor))
        wav = timed("hifigan", lambda: backend.vocoder(mel))
    return z, wav, sec


def phase_audioldm_small(torch) -> None:
    """25a, small: the AudioLDM stack on the card against the CPU, same
    weights, x_t and per-step noise, DDIM at eta 0 and 0.5."""
    from v2ap_torch.evaluation.clap_scorer import _fallback_tokenize
    from v2ap_torch.models.latent_diffusion import make_ddim_schedule

    cpu = ldm_small_backend(torch, "cpu")
    fill_zero_params(torch, cpu, 25)
    card = ldm_small_backend(torch, "cuda")
    card.load_state_dict(cpu.state_dict())
    vocab = cpu.clap.text_model.cfg.vocab_size
    ids, mask = (torch.from_numpy(a) for a in _fallback_tokenize(
        list(AUDIOLDM_PROMPTS), vocab, 16))
    u_ids, u_mask = (torch.from_numpy(a) for a in _fallback_tokenize(
        [""], vocab, 16))
    gen = torch.Generator().manual_seed(25)
    x_t = torch.randn(cpu.latent_shape(2), generator=gen)
    steps = 10
    for eta in (0.0, 0.5):
        rows = len(make_ddim_schedule(cpu.ldm.cfg, steps, eta))
        noise = torch.randn((rows,) + x_t.shape, generator=gen)
        out = {}
        for name, m in (("card", card), ("cpu", cpu)):
            dev = next(m.parameters()).device
            z, wav, _ = audioldm_stages(
                torch, m, ids.to(dev), mask.to(dev), u_ids.to(dev),
                u_mask.to(dev), x_t.to(dev), noise=noise.to(dev), eta=eta,
                steps=steps)
            out[name] = (z.cpu(), wav.cpu())
        for i, what in enumerate(("latents", "waveform")):
            g, c = out["card"][i], out["cpu"][i]
            err = rel_rms(g, c)
            log(f"  small AudioLDM eta {eta} {what} {tuple(g.shape)}: rel-RMS "
                f"card vs CPU {err:.2e} (tol {SMALL_REL_RMS})")
            if not torch.isfinite(g).all() or err > SMALL_REL_RMS:
                raise RuntimeError(f"AudioLDM small: {what} at eta {eta} "
                                   f"disagree ({err})")


def phase_audioldm(torch) -> dict:
    """25a, full width: AudioLDMBackend(ldm_s_full()) with the default CLAP,
    VAE and HiFi-GAN from seeded weights on the card."""
    import numpy as np

    from v2ap_torch.evaluation.clap_scorer import _fallback_tokenize
    from v2ap_torch.models.latent_diffusion import AudioLDMBackend, ldm_s_full
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.utils.device import seeded_init

    phase_audioldm_small(torch)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with seeded_init(0, dev):
        backend = AudioLDMBackend(ldm_s_full(), device=dev)
    filled = fill_zero_params(torch, backend, 26)
    torch.cuda.synchronize()
    count = {name: sum(p.numel() for p in getattr(backend, name).parameters())
             for name in ("ldm", "clap", "vae", "vocoder")}
    log(f"  build: {time.perf_counter() - t0:.2f} s, parameters (M) "
        f"{', '.join(f'{k} {v / 1e6:.1f}' for k, v in count.items())}; "
        f"{filled} zero-initialised tensors seeded")
    vocab = backend.clap.text_model.cfg.vocab_size
    ids, mask = (torch.from_numpy(a).to(dev) for a in _fallback_tokenize(
        list(AUDIOLDM_PROMPTS), vocab))
    u_ids, u_mask = (torch.from_numpy(a).to(dev) for a in _fallback_tokenize(
        [""], vocab))
    x_t = torch.randn(backend.latent_shape(len(AUDIOLDM_PROMPTS)),
                      generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)

    def run():
        return backend.text_to_audio(ids, mask, u_ids, u_mask,
                                     steps=AUDIOLDM_STEPS,
                                     guidance_scale=AUDIOLDM_GUIDANCE,
                                     x_t=x_t)

    t0 = time.perf_counter()
    wav = run()
    torch.cuda.synchronize()
    log(f"  warm-up text_to_audio: {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(AUDIOLDM_RUNS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wav = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if any(launch_counts.values()):
            raise RuntimeError(f"AudioLDM: a flash kernel ran: "
                               f"{dict(launch_counts)}")
    want = (len(AUDIOLDM_PROMPTS), AUDIOLDM_SAMPLES)
    if tuple(wav.shape) != want or not torch.isfinite(wav).all() or \
            not wav.abs().max() > 0:
        raise RuntimeError(f"AudioLDM: waveform {tuple(wav.shape)} (want "
                           f"{want}), finite {bool(torch.isfinite(wav).all())}"
                           f", max |x| {wav.abs().max().item()}")
    stages = []
    for _ in range(AUDIOLDM_RUNS):
        _, staged, sec = audioldm_stages(torch, backend, ids, mask, u_ids,
                                         u_mask, x_t)
        stages.append(sec)
    def profiled():
        out = run()
        if not torch.isfinite(out).all():
            raise RuntimeError("AudioLDM profile: non-finite waveform")

    phase_profile(torch, "text_to_audio", profiled)
    # the same calls; cuDNN may pick another algorithm between them
    staged_err = rel_rms(staged, wav)
    if staged_err > SMALL_PARAM_REL_RMS:
        raise RuntimeError(f"AudioLDM: the staged run differs from "
                           f"text_to_audio ({staged_err:.2e})")
    med = {k: float(np.median([s[k] for s in stages])) for k in stages[0]}
    wall = float(np.median(walls))
    audio_s = len(AUDIOLDM_PROMPTS) * AUDIOLDM_SAMPLES / 16_000
    log(f"  text_to_audio x{AUDIOLDM_RUNS} ({len(AUDIOLDM_PROMPTS)} prompts, "
        f"{AUDIOLDM_STEPS} DDIM steps, guidance {AUDIOLDM_GUIDANCE}, eta 0, "
        f"f32, TF32 off): wall (s) {', '.join(f'{w:.4f}' for w in walls)}; "
        f"median {wall:.4f} s, {audio_s / wall:.2f} audio-s per s; stages "
        f"(median of {AUDIOLDM_RUNS} staged runs) "
        f"{', '.join(f'{k} {v:.4f}' for k, v in med.items())} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; waveform "
        f"{tuple(wav.shape)} at 16 kHz, max |x| {wav.abs().max().item():.4f}; "
        f"staged vs text_to_audio rel-RMS {staged_err:.2e} (tol "
        f"{SMALL_PARAM_REL_RMS}); no flash kernel launched")
    del backend
    torch.cuda.empty_cache()
    return {"wall": wall, **med}


def plain_overlap_add(torch, td, hop: int):
    """The loop-and-scatter overlap-add: frame t added at t * hop."""
    b, frames, n = td.shape
    out = torch.zeros(b, (frames - 1) * hop + n, device=td.device,
                      dtype=td.dtype)
    for t in range(frames):
        out[:, t * hop: t * hop + n] += td[:, t]
    return out


def phase_vocos(torch) -> float:
    """25b: Vocos at vocos_mel_24khz() on a seeded 10 s mel."""
    import numpy as np

    from v2ap_torch.models import vocos as V
    from v2ap_torch.utils.device import seeded_init

    cfg = V.vocos_mel_24khz()
    with seeded_init(0, torch.device("cpu")):
        cpu = V.Vocos(cfg, device="cpu")
    card = V.Vocos(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    mel = torch.randn(1, VOCOS_FRAMES, cfg.input_channels,
                      generator=torch.Generator().manual_seed(25))
    with torch.no_grad():
        got = card.decode(mel.cuda())
        want = cpu.decode(mel)
        out = card.head(card.backbone(mel.cuda())).float()
        half = cfg.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(out[..., :half]), max=1e2)
        spec = torch.complex(mag * torch.cos(out[..., half:]),
                             mag * torch.sin(out[..., half:]))
        fast = V.istft(spec, cfg.n_fft, cfg.hop_length)
        td = torch.fft.irfft(spec, n=cfg.n_fft, dim=-1) * torch.from_numpy(
            V._hann(cfg.n_fft)).cuda()
        env = torch.from_numpy(V._envelope(VOCOS_FRAMES, cfg.n_fft,
                                           cfg.hop_length)).cuda()
        plain = plain_overlap_add(torch, td, cfg.hop_length) / env
        plain = plain[:, cfg.n_fft // 2: plain.shape[1] - cfg.n_fft // 2]
    n = (VOCOS_FRAMES - 1) * cfg.hop_length
    for what, g, c in (("istft vs plain overlap-add", fast, plain),
                       ("waveform card vs CPU", got, want)):
        err = rel_rms(g.cpu(), c.cpu())
        log(f"  Vocos {what} {tuple(g.shape)}: rel-RMS {err:.2e} (tol "
            f"{VOCOS_REL_RMS})")
        if tuple(g.shape) != (1, n) or not torch.isfinite(g).all() or \
                err > VOCOS_REL_RMS:
            raise RuntimeError(f"Vocos: {what} ({err}, {tuple(g.shape)})")
    with torch.no_grad():
        ms = events_ms(torch, lambda: card.decode(mel.cuda()), VOCOS_REPS)
    med = float(np.median(ms))
    log(f"  Vocos decode of {VOCOS_FRAMES} frames ({n} samples, "
        f"{n / cfg.sampling_rate:.2f} s at 24 kHz): ms per clip "
        f"{', '.join(f'{m:.3f}' for m in ms)}; median {med:.3f} ms")
    del card, cpu
    torch.cuda.empty_cache()
    return med


def phase_vae_vocoder(torch) -> float:
    """25c: VaeVocoder.decode of seeded flat latents at the default
    widths."""
    import numpy as np

    from v2ap_torch.models.audioldm_vae import VaeVocoder
    from v2ap_torch.utils.device import seeded_init

    dev = torch.device("cuda")
    with seeded_init(0, dev):
        voc = VaeVocoder(device=dev)
    lat = torch.randn(VAE_VOCODER_LATENTS, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(25))
    b, l, _ = VAE_VOCODER_LATENTS
    want = (b, 160 * 4 * l + 32)
    with torch.no_grad():
        wav = voc.decode(lat)
        torch.cuda.synchronize()
        if tuple(wav.shape) != want or not torch.isfinite(wav).all():
            raise RuntimeError(f"VaeVocoder: {tuple(wav.shape)} (want "
                               f"{want}), finite "
                               f"{bool(torch.isfinite(wav).all())}")
        torch.cuda.reset_peak_memory_stats()
        ms = events_ms(torch, lambda: voc.decode(lat), VAE_VOCODER_REPS)
    med = float(np.median(ms))
    log(f"  VaeVocoder.decode {VAE_VOCODER_LATENTS} -> {tuple(wav.shape)} "
        f"({want[1] / 16_000:.2f} s at 16 kHz each): ms "
        f"{', '.join(f'{m:.1f}' for m in ms)}; median {med:.1f} ms; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del voc
    torch.cuda.empty_cache()
    return med


def _pred_inputs(torch, cfg, b: int, n: int, seed: int, device):
    import numpy as np

    from v2ap_torch.data.tokenizers import byte_tokenizer

    rng = np.random.default_rng(seed)
    latents = torch.from_numpy(rng.normal(size=(b, n, cfg.num_channels))
                               .astype(np.float32)).to(device)
    enc, _ = byte_tokenizer()
    tokens = torch.from_numpy(enc([PRED_TEXTS[i % len(PRED_TEXTS)]
                                   for i in range(b)])).to(device)
    lens = torch.from_numpy(rng.integers(n // 2, n + 1, size=b)).to(device)
    return latents, tokens, lens


def phase_duration_small(torch) -> None:
    """25d, small: the predictor in f32 on the card against the CPU, same
    weights and ``frac``: prediction, loss and every gradient."""
    from v2ap_torch import config as C
    from v2ap_torch.models.duration import DurationPredictor
    from v2ap_torch.utils.device import seeded_init

    base = C.tiny_test().model
    cfg = dataclasses.replace(base, dim=128, heads=2, dim_head=64,
                              dim_text=128, text_heads=2, text_dim_head=64,
                              dim_frames=64, frames_heads=1,
                              frames_dim_head=64, dim_context=128)
    with seeded_init(5, torch.device("cpu")):
        cpu = DurationPredictor(cfg, device="cpu")
    fill_zero_params(torch, cpu, 27)
    card = DurationPredictor(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    latents, tokens, lens = _pred_inputs(torch, cfg, 3, 96, 25, "cpu")
    frac = torch.tensor([0.9, 0.5, 0.75])
    res = {}
    for name, m in (("card", card), ("cpu", cpu)):
        dev = next(m.parameters()).device
        args = (latents.to(dev), tokens.to(dev), lens.to(dev))
        with torch.no_grad():
            pred = m(*args)
        m.zero_grad()
        loss = m.loss(*args, frac=frac)
        loss.backward()
        res[name] = (pred.cpu(), loss.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()
                      if p.grad is not None})
    worst = max(rel_rms(res["card"][2][k], g)
                for k, g in res["cpu"][2].items())
    for what, g, c in (("prediction", res["card"][0], res["cpu"][0]),
                       ("loss", res["card"][1], res["cpu"][1])):
        err = rel_rms(g, c)
        log(f"  small f32 predictor {what}: rel-RMS card vs CPU {err:.2e} "
            f"(tol {SMALL_REL_RMS})")
        if err > SMALL_REL_RMS:
            raise RuntimeError(f"predictor small: {what} disagree ({err})")
    log(f"  small f32 predictor gradients ({len(res['cpu'][2])} tensors): "
        f"worst rel-RMS card vs CPU {worst:.2e} (tol {SMALL_REL_RMS})")
    if res["card"][2].keys() != res["cpu"][2].keys() or worst > SMALL_REL_RMS:
        raise RuntimeError(f"predictor small: gradients disagree ({worst})")


def phase_duration(torch) -> dict:
    """25d, full width: DurationPredictor at v2a_default()'s transformer
    (12 layers, bf16 compute, f32 params), byte tokens, PRED_BATCH x 750
    latents: the forward's K1 launches, timed AdamW steps with K3-K5
    counted, peak memory, and a profile of one forward + backward."""
    import numpy as np

    from v2ap_torch import config as C
    from v2ap_torch.models.duration import DurationPredictor
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.utils.device import seeded_init

    phase_duration_small(torch)
    cfg = C.v2a_default().model
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with seeded_init(0, dev):
        model = DurationPredictor(cfg, device=dev)
    fill_zero_params(torch, model, 28)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    latents, tokens, lens = _pred_inputs(torch, cfg, PRED_BATCH,
                                         TRAIN_LATENTS, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # per layer: the audio self-attention, the audio cross-attention (with
    # no prompt and dim_context == dim, a self-attention over the audio
    # stream), and the text and frames streams' self-attentions
    per_call = 4 * cfg.depth
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M f32 "
        f"params, {cfg.depth} layers, batch {PRED_BATCH} x {TRAIN_LATENTS} "
        f"latents, lens {lens.tolist()}, byte tokens {tuple(tokens.shape)}")
    zero = dict.fromkeys(launch_counts, 0)
    with torch.no_grad():
        pred = model(latents, tokens, lens)
        walls = []
        for _ in range(PRED_FWD_REPS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            pred = model(latents, tokens, lens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = dict(launch_counts)
            want = {**zero, "flash_attention_packed": per_call,
                    **norm_expect(cfg, 1)}
            if counts != want:
                raise RuntimeError(f"predictor forward: launches {counts}, "
                                   f"expected {want}")
    if not torch.isfinite(pred).all() or not (pred > 0).all():
        raise RuntimeError(f"predictor: prediction {pred.tolist()}")
    fwd = float(np.median(walls))
    log(f"  forward x{PRED_FWD_REPS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {fwd:.4f} s; K1 "
        f"{per_call} a forward (4 attentions x {cfg.depth} layers), N1 and "
        f"N2 {norm_expect(cfg, 1)}, nothing else; predictions "
        f"{', '.join(f'{x:.1f}' for x in pred.tolist())}")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(latents, tokens, lens, generator=gen)
        loss.backward()
        opt.step()
        return loss

    expect = {**zero, "flash_attention_lse": per_call,
              "flash_attention_bwd_dq": per_call,
              "flash_attention_bwd_dkv": per_call}
    watch = model.to_pred.weight.detach().clone()
    loss = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(PRED_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if dict(launch_counts) != expect:
            raise RuntimeError(f"predictor step: launches "
                               f"{dict(launch_counts)} != {expect}")
    moved = (model.to_pred.weight - watch).abs().max().item()
    if not np.isfinite(losses).all() or not moved:
        raise RuntimeError(f"predictor step: losses {losses}, to_pred moved "
                           f"{moved}")
    wall = float(np.median(walls))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  loss + backward + AdamW x{PRED_STEPS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s; peak "
        f"{peak:.2f} GiB; losses {', '.join(f'{x:.1f}' for x in losses)}; "
        f"K3, K4, K5 {per_call} a step, K1 none")

    def profiled():
        model.zero_grad(set_to_none=True)
        loss = model.loss(latents, tokens, lens, generator=gen)
        loss.backward()
        if not torch.isfinite(loss):
            raise RuntimeError("predictor profile: non-finite loss")

    phase_profile(torch, "predictor forward + backward", profiled,
                  ("flash_fwd_sm90_kernel<64>",) + SM90_BWD)
    del model, opt
    torch.cuda.empty_cache()
    return {"fwd": fwd, "step": wall, "peak_gib": peak, "k1": per_call}


def phase_25(torch) -> None:
    log("[25a/27] AudioLDM text-to-audio: small card vs CPU (eta 0, 0.5); "
        "ldm_s_full() with CLAP, VAE and HiFi-GAN at full width")
    t0 = time.perf_counter()
    phase_audioldm(torch)
    log(f"  phase 25a: {time.perf_counter() - t0:.2f} s")
    log(f"[25b/27] Vocos vocos_mel_24khz(): {VOCOS_FRAMES} frames, istft vs "
        f"plain overlap-add, card vs CPU")
    t0 = time.perf_counter()
    phase_vocos(torch)
    log(f"  phase 25b: {time.perf_counter() - t0:.2f} s")
    log(f"[25c/27] VaeVocoder.decode of {VAE_VOCODER_LATENTS} flat latents")
    t0 = time.perf_counter()
    phase_vae_vocoder(torch)
    log(f"  phase 25c: {time.perf_counter() - t0:.2f} s")
    log("[25d/27] DurationPredictor at v2a_default()'s transformer: small f32 "
        "card vs CPU; forward (K1), AdamW steps (K3-K5), profile")
    t0 = time.perf_counter()
    phase_duration(torch)
    log(f"  phase 25d: {time.perf_counter() - t0:.2f} s")


# --------------------------------------------------------------- phase 26

TP_TIMEOUT_S = 600                 # phase 26b's processes, from their start
# bf16, TP 2 against the unsharded port on the card (rel-RMS). Each limit
# lies between its reading and the readings of planted faults (``python3
# chip_smoke.py --tp-limits``; PERF.md section 6). Each tensor's change in
# the step and the updated weights are printed, not held: AdamW's first
# update is about lr x sign(g), blind to a gradient's scale, and a sign
# flipped by rounding in a 16-element gate bias moves its reading by 0.5
TP_FEAT_REL = 2e-2                 # tower features
TP_LAT_REL = 1e-2                  # the 25-step sample's latents
TP_GRAD_REL = 5e-2                 # each clipped gradient tensor
# the planted faults of --tp-limits, and the parts of 26b each can move
TP_FAULTS = {None: ("tower", "sample", "step"),
             "rowsum": ("tower", "sample", "step"),
             "gates": ("sample", "step"),
             "partial": ("step",),
             "bias": ("step",)}     # the biases are zero before the step


def world1_mesh(torch, root: str):
    """A process group of this process alone under NCCL (``init_distributed``
    forms none for one process), and the default ``MeshConfig()`` mesh over
    it (data 1 x model 1)."""
    import datetime

    import torch.distributed as dist

    from v2ap_torch.config import MeshConfig
    from v2ap_torch.parallel import make_mesh

    store = os.path.join(root, f"rdzv_{time.monotonic_ns()}")
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    return make_mesh(MeshConfig())


def tp_references(torch, pipe, frames, tp_dir: str, inputs=None) -> None:
    """What phase (b) is held against, from phase 5's pipeline: the
    sampler's inputs for the clip (``inputs`` (x0, text) when taken
    already) and ViT-bigG's bf16 features of its first 64 frames."""
    from v2ap_torch.models.clip_vit import device_normalize

    x0, text = inputs or sampler_inputs(torch, pipe, frames)[:2]
    torch.save({"x0": x0.cpu(), "text": text.cpu()},
               os.path.join(tp_dir, "sample_in.pt"))
    tower = pipe.towers[0]
    with torch.inference_mode():
        px = device_normalize(tower.preprocess(
            torch.from_numpy(frames[:64]).cuda()), tower.mean, tower.std)
        feats = tower.model(px)

        def nudge(_, args):
            # every 97th input of the first block one bf16 ulp larger in
            # magnitude
            x = args[0].clone()
            x.view(-1).view(torch.int16)[::97] += 1
            return (x,)

        hook = tower.model.blocks[0].register_forward_pre_hook(nudge)
        try:
            floor = rel_rms(tower.model(px).float(), feats.float())
        finally:
            hook.remove()
    log(f"  bf16 noise floor of the unsharded ViT-bigG: features "
        f"{floor:.3e} rel-RMS off when 1 % of the first block's inputs "
        f"move by one bf16 ulp")
    torch.save(feats.float().cpu(), os.path.join(tp_dir, "tower_ref.pt"))


def phase_26_serve(torch, pipe, frames, tp_dir: str) -> None:
    """(d) the captured sampler is deterministic; (c) YUV 4:2:0 against RGB
    tower features at full width; the tower features and sampler inputs
    the two-rank phase (b) is held against; (a) ``shard_serving`` over a
    world-1 NCCL mesh, then ``generate``, bit-equal to the plain generate,
    the sampler captured anew."""
    import numpy as np
    import torch.distributed as dist

    from v2ap_torch import config as C
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.utils.determinism import assert_deterministic

    x0, text, roll, ctx, cmask, mask = sampler_inputs(torch, pipe, frames)
    cfg25 = C.SamplerConfig(steps=25, cfg_strength=2.0)
    t0 = time.perf_counter()
    assert_deterministic(
        lambda: pipe._sample(x0, text, roll, ctx, cmask, mask, cfg25))
    log(f"  (d) assert_deterministic(captured 25-step sampler, runs 2): ok, "
        f"{time.perf_counter() - t0:.3f} s")
    tp_references(torch, pipe, frames, tp_dir, (x0, text))

    walls = {}
    out = {}
    for mode in (False, True, False):
        pipe.ship_yuv420 = mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode], _ = pipe.encode_video_frames_clip(
            None, 768, frames_cache=[(frames, CLIP_S, 1)])
        torch.cuda.synchronize()
        walls.setdefault(mode, []).append(time.perf_counter() - t0)
    pipe.ship_yuv420 = False
    drift = rel_rms(out[True], out[False])
    log(f"  (c) V2AP_SHIP_YUV420 at full width ({len(frames)} frames, "
        f"ViT-bigG bf16): feature drift {drift:.4%} rel-RMS against RGB; "
        f"walls RGB {walls[False][-1]:.4f} s, YUV {walls[True][0]:.4f} s "
        f"(geometry and pack on the host through the host library, unpack "
        f"on the card)")
    # uniform-noise pixels are the 2x2 chroma averaging's worst case: the
    # bound is a sanity one (the features are the tower's, not noise)
    if not torch.isfinite(out[True]).all() or not drift < 1.0:
        raise RuntimeError(f"YUV features: drift {drift}")

    def gen():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    plain, _ = gen()
    mesh = world1_mesh(torch, tp_dir)
    try:
        pipe.shard_serving(mesh)
        if pipe.graphs is None:
            raise RuntimeError("shard_serving under NCCL left the sampler "
                               "uncaptured")
        t0 = time.perf_counter()
        first, _ = gen()                           # captures anew
        t_first = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        again, _ = gen()                           # replays
        t_again = time.perf_counter() - t0
        counts = dict(launch_counts)
    finally:
        dist.destroy_process_group()
    expect = generate_expect(pipe, len(frames))
    same = np.array_equal(first, plain) and np.array_equal(again, plain)
    log(f"  (a) shard_serving(make_mesh(MeshConfig())) over a world-1 NCCL "
        f"group: generate bit-equal to the plain one {same}; walls "
        f"{t_first:.4f} s (capture) and {t_again:.4f} s; captures "
        f"{len(pipe.graphs.captures)}; launches {counts}")
    if not same or len(pipe.graphs.captures) != 1 or counts != expect:
        raise RuntimeError(f"mesh generate: bit-equal {same}, captures "
                           f"{len(pipe.graphs.captures)}, launches {counts}")


def phase_26_strips(torch, pipe, strips) -> None:
    """(c) the strip-half shipping mode against exact strips at full width:
    the roll of a 10 s clip (768 rows) both ways."""
    rows = pipe.encode_piano_frames(None, 768, strips_cache=[(strips, CLIP_S)])
    rolls, walls = {}, {}
    for half in (False, True, False):
        pipe.ship_strip_half = half
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rolls[half] = pipe._roll_from_strips(pipe._ship_strips(rows), 768)
        torch.cuda.synchronize()
        walls[half] = time.perf_counter() - t0
    pipe.ship_strip_half = False
    drift = rel_rms(rolls[True], rolls[False])
    log(f"  (c) V2AP_SHIP_STRIP_HALF at full width ({len(rows)} strips of "
        f"100x900 -> 100x450 on the wire): roll drift {drift:.4%} rel-RMS "
        f"against exact strips; walls exact {walls[False]:.4f} s, half "
        f"{walls[True]:.4f} s")
    if not torch.isfinite(rolls[True]).all() or not drift < 1.0:
        raise RuntimeError(f"strip-half roll: drift {drift}")


def phase_26_train(torch, tp_dir: str) -> None:
    """A fresh v2a_default() CFM from seed 0 and phase 14's batch: the
    25-step sample and one train step that phase (b) is held against;
    (d) the step is deterministic; (a) the step through a world-1 NCCL mesh
    (``Trainer(mesh=)``) is bit-equal to the plain one."""
    import torch.distributed as dist

    from v2ap_torch import config as C
    from v2ap_torch.training import Trainer
    from v2ap_torch.utils.determinism import assert_deterministic

    trainer, batch = full_trainer(torch, train_cfg=C.TrainConfig())
    model = trainer.model
    del trainer
    inp = torch.load(os.path.join(tp_dir, "sample_in.pt"))
    x0, text = inp["x0"].cuda(), inp["text"].cuda()
    m = model.cfg
    t0 = time.perf_counter()
    with torch.no_grad():
        lat = model.sample(
            x0, text_embed=text,
            frames_embed=torch.zeros(1, 768, m.notes, device="cuda"),
            context=torch.zeros(1, 1, m.dim_context, device="cuda"),
            context_mask=torch.ones(1, 1, dtype=torch.bool, device="cuda"),
            mask=torch.arange(768, device="cuda")[None] < 750,
            sampler=C.SamplerConfig(steps=25, cfg_strength=2.0))
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    log(f"  unsharded reference: 25-step eager sample {t_sample:.3f} s")
    torch.save(lat.cpu(), os.path.join(tp_dir, "lat_ref.pt"))
    s0 = {k: v.clone() for k, v in model.state_dict().items()}
    g0 = model.dropout_generator.get_state()

    runs = []

    def step(mesh=None):
        """One step from s0 and the generator's state g0 (a fresh
        optimizer); the updated tensors stay in ``runs``, the loss and a
        float64 sum of each updated tensor are returned."""
        with torch.no_grad():
            model.load_state_dict(s0)
        model.dropout_generator.set_state(g0)
        for p in model.parameters():
            p.grad = None
        tr = Trainer(model, C.TrainConfig(), mesh=mesh)
        loss, _ = tr.train_step(batch)
        out = {"loss": loss.detach().clone()}
        out.update({k: p.detach().clone()
                    for k, p in model.named_parameters()})
        out.update({f"grad:{k}": p.grad.clone()
                    for k, p in model.named_parameters()})
        runs.append(out)
        return {"loss": out["loss"], "sums": torch.stack(
            [v.double().sum() for k, v in out.items()
             if k != "loss" and not k.startswith("grad:")])}

    t0 = time.perf_counter()
    assert_deterministic(step)
    plain = runs[0]
    log(f"  (d) assert_deterministic(one full-width train step: the loss "
        f"and each updated tensor's float64 sum, runs 2): ok, "
        f"{time.perf_counter() - t0:.3f} s")
    del runs[1:]
    mesh = world1_mesh(torch, tp_dir)
    try:
        step(mesh)
        meshed = runs.pop()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(meshed[k], v) for k, v in plain.items())
    log(f"  (a) Trainer(mesh=make_mesh(MeshConfig())) over a world-1 NCCL "
        f"group: loss {meshed['loss'].item():.6f}, loss, every clipped "
        f"gradient and every updated tensor bit-equal to the plain step: "
        f"{same}")
    if not same:
        raise RuntimeError("the mesh train step differs from the plain one")
    # each tensor's change in the step and its clipped gradient, float32
    # (6.2 GB for the 776.7 M parameters)
    ref = {f"upd:{k}": (plain[k] - s0[k]).cpu()
           for k, _ in model.named_parameters()}
    ref.update({k: v.cpu() for k, v in plain.items()
                if k.startswith("grad:")})
    torch.save(ref, os.path.join(tp_dir, "step_ref.pt"))
    del model, plain, meshed, s0, ref
    torch.cuda.empty_cache()


def plant_tp_fault(fault: str, model) -> None:
    """A deliberately wrong split, for the upper readings of phase (b)'s
    limits (``--tp-limits``): ``rowsum``, the row-parallel products' partial
    outputs not summed over the model group; ``gates``, each rank's value
    gates taken from the other rank's heads; ``partial``, the partly-used
    replicated parameters' gradients not summed; ``bias``, each
    row-parallel layer adding its bias on every rank (twice at TP 2)."""
    from v2ap_torch.ops.attention import Attention
    from v2ap_torch.ops.layers import Linear
    from v2ap_torch.parallel.distributed import row_partial

    def unsummed(lin, x):
        y = row_partial(x.to(lin.dtype), lin.weight.to(lin.dtype))
        return (y if lin.bias is None else y + lin.bias.float()).to(lin.dtype)

    for m in model.modules():
        if fault == "rowsum" and isinstance(m, Linear) and \
                m.tp is not None and m.tp.mode == "row":
            m.tp = unsummed
        elif fault == "gates" and isinstance(m, Attention) and \
                m.tp is not None and m.to_v_gates is not None:
            group, h0 = m.tp
            m.tp = (group, (h0 + m.heads) % (2 * m.heads))
        elif fault == "partial":
            for p in m.parameters(recurse=False):
                if getattr(p, "_tp_partial", False):
                    del p._tp_partial
        elif fault == "bias" and isinstance(m, Linear) and \
                m.tp is not None and m.tp.mode.startswith("row") and \
                m.bias is not None:
            m.tp = (lambda lin, x, tp=m.tp:
                    tp(lin, x) + lin.bias.to(lin.dtype))


def tp_rank_main(rank: int, tp_dir: str, fault: str | None = None) -> int:
    """One of phase (b)'s two ranks: gloo over CUDA tensors on the one card,
    TP 2. ViT-bigG over 64 frames, the CFM's 25-step sample and one train
    step, each held against the unsharded results of the same card; the
    launch counts, walls, readings and this rank's peak memory go to
    ``rank<r>_<fault>.json``. With ``fault`` (``plant_tp_fault``) only the
    parts the fault can move run."""
    import torch

    sys.path.insert(0, ROOT)
    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.models.clip_vit import device_normalize
    from v2ap_torch.models.video_towers import build_video_towers
    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)
    from v2ap_torch.parallel import make_mesh, shard_model
    from v2ap_torch.parallel.distributed import init_distributed
    from v2ap_torch.parallel.state import shard_like
    from v2ap_torch.training import Trainer
    from v2ap_torch.utils.device import seeded_init

    t_start = time.perf_counter()
    parts = TP_FAULTS[fault]
    tag = fault or "none"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_distributed(f"file://{os.path.join(tp_dir, f'rdzv_{tag}')}", 2,
                     rank, backend="gloo", device=dev,
                     timeout_s=TP_TIMEOUT_S)
    mesh = make_mesh(C.MeshConfig(model_parallel=2))
    res = {"fault": fault}

    def timed(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: v for k, v in launch_counts.items() if v}

    if "tower" in parts:
        tower = build_video_towers("clip_vit", seed=3, device=dev)[0]
        tower.model.to(torch.bfloat16).eval().requires_grad_(False)
        shard_model(tower.model, mesh)
        plant_tp_fault(fault, tower.model)
        px = torch.from_numpy(clip_frames()[:64]).to(dev)
        with torch.inference_mode():
            feats, res["tower_s"], res["tower_launches"] = timed(
                lambda: tower.model(device_normalize(
                    tower.preprocess(px), tower.mean, tower.std)))
        res["tower_rel_rms"] = rel_rms(feats.float().cpu(), torch.load(
            os.path.join(tp_dir, "tower_ref.pt")))
        del tower, feats
    cfg = C.v2a_default()
    with seeded_init(0, dev):
        model = CFM(cfg.model, cfg.conditioning, device=dev)
    shard_model(model, mesh)
    plant_tp_fault(fault, model)
    m = cfg.model

    if "sample" in parts:
        inp = torch.load(os.path.join(tp_dir, "sample_in.pt"))

        def sample():
            with torch.no_grad():
                return model.sample(
                    inp["x0"].to(dev), text_embed=inp["text"].to(dev),
                    frames_embed=torch.zeros(1, 768, m.notes, device=dev),
                    context=torch.zeros(1, 1, m.dim_context, device=dev),
                    context_mask=torch.ones(1, 1, dtype=torch.bool,
                                            device=dev),
                    mask=torch.arange(768, device=dev)[None] < 750,
                    sampler=C.SamplerConfig(steps=25, cfg_strength=2.0))

        lat, res["sample_s"], res["sample_launches"] = timed(sample)
        res["lat_rel_rms"] = rel_rms(lat.cpu(), torch.load(
            os.path.join(tp_dir, "lat_ref.pt")))
    w0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = Trainer(model, C.TrainConfig(), mesh=mesh)
    batch = train_batch(torch, cfg, dev=dev)
    (loss, _), res["step_s"], res["step_launches"] = timed(
        lambda: trainer.train_step(batch))
    res["loss"] = loss.item()
    ref = torch.load(os.path.join(tp_dir, "step_ref.pt"), mmap=True)
    worst = {"upd": (0.0, None), "param": (0.0, None), "grad": (0.0, None)}
    for k, p in model.named_parameters():
        upd = shard_like(p, ref[f"upd:{k}"].to(dev))
        for kind, got, want in (
                ("upd", p.detach() - w0[k], upd),
                ("param", p.detach(), w0[k] + upd),
                ("grad", p.grad, shard_like(p, ref[f"grad:{k}"].to(dev)))):
            d = rel_rms(got, want)
            if d > worst[kind][0]:
                worst[kind] = (d, k)
    for kind, (d, k) in worst.items():
        res[f"{kind}_rel_rms"], res[f"{kind}_worst"] = d, k
    res.update(peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               total_s=time.perf_counter() - t_start)
    with open(os.path.join(tp_dir, f"rank{rank}_{tag}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_26_start(tp_dir: str, fault: str | None = None,
                   dry_run: bool = True) -> dict:
    """(b) TP 2 with two ranks sharing the card through gloo over CUDA
    tensors (``tp_rank_main``), and with ``dry_run`` beside them the
    multichip dry run (``python -m v2ap_torch.parallel.dryrun``, 2 ranks,
    TP 2, gloo on the card, f32 tiny, every phase), started in the
    background: in the full run they run while phase 24a writes and
    converts its snapshots (24a's walls are not taken), and
    ``phase_26_finish`` collects them. Walls are no speed figure: gloo
    stages every collective through the host, and the card is shared."""
    cmds = [[sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
             "--tp-dir", tp_dir] + (["--tp-fault", fault] if fault else [])
            for r in range(2)]
    if dry_run:
        cmds.append([sys.executable, "-m", "v2ap_torch.parallel.dryrun",
                     "--world-size", "2", "--model-parallel", "2",
                     "--device", "cuda", "--backend", "gloo", "--out",
                     os.path.join(tp_dir, "dry"), "--timeout",
                     str(TP_TIMEOUT_S)])
    tag = fault or "none"
    logs = [os.path.join(tp_dir, f"proc{i}_{tag}.log")
            for i in range(len(cmds))]
    procs = []
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                          stderr=subprocess.STDOUT))
    return {"procs": procs, "logs": logs, "t0": time.perf_counter(),
            "dir": tp_dir, "fault": fault}


def phase_26_stop(run: dict) -> None:
    """Kill phase 26b's processes that still run."""
    for p in run["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def tp_reading(res: dict) -> str:
    """One rank's walls, launches, readings and peak memory."""
    out = []
    if "tower_s" in res:
        out.append(f"tower 64 frames {res['tower_s']:.3f} s "
                   f"{res['tower_launches']}, features "
                   f"{res['tower_rel_rms']:.3e} rel-RMS (tol {TP_FEAT_REL})")
    if "sample_s" in res:
        out.append(f"sample {res['sample_s']:.3f} s "
                   f"{res['sample_launches']}, latents "
                   f"{res['lat_rel_rms']:.3e} (tol {TP_LAT_REL})")
    out.append(
        f"step {res['step_s']:.3f} s {res['step_launches']}, loss "
        f"{res['loss']:.6f}; worst clipped gradient {res['grad_rel_rms']:.3e}"
        f" ({res['grad_worst']}; tol {TP_GRAD_REL}); no limit on the worst "
        f"update {res['upd_rel_rms']:.3e} ({res['upd_worst']}) and updated "
        f"weight {res['param_rel_rms']:.3e} ({res['param_worst']})")
    out.append(f"peak {res['peak_gib']:.2f} GiB; {res['total_s']:.1f} s from "
               f"the rank's start")
    return "; ".join(out)


def phase_26_finish(run: dict, check: bool = True) -> list:
    """Wait for phase 26b's processes (at most TP_TIMEOUT_S from their
    start; every one of them is stopped after), print each rank's readings
    and, with ``check``, hold them and the dry run."""
    procs = run["procs"]
    tag = run["fault"] or "none"
    try:
        for p in procs:
            left = max(1.0, TP_TIMEOUT_S - (time.perf_counter() - run["t0"]))
            p.wait(timeout=left)
        outs = [open(path).read() for path in run["logs"]]
    finally:
        phase_26_stop(run)
    for p, out in zip(procs[:2], outs):
        if p.returncode != 0:
            raise RuntimeError(f"phase 26b rank failed ({p.returncode}):"
                               f"\n{out[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(run["dir"], f"rank{r}_{tag}.json")) as f:
            ranks.append(json.load(f))
        log(f"  (b) rank {r}"
            + (f", planted fault {run['fault']}" if run["fault"] else "")
            + ": " + tp_reading(ranks[-1]))
    if check:
        _check_26b(ranks, procs, outs)
    return ranks


def _check_26b(ranks, procs, outs) -> None:
    for r, res in enumerate(ranks):
        bad = (res["lat_rel_rms"] > TP_LAT_REL
               or res["grad_rel_rms"] > TP_GRAD_REL
               or res["tower_rel_rms"] > TP_FEAT_REL
               or res["tower_launches"] != {"flash_attention": 48}
               or res["sample_launches"] != {"flash_attention_packed": 1152,
                                             "rms_norm": 2040,
                                             "gated_residual": 864}
               or res["step_launches"] != {"flash_attention_lse": 48,
                                           "flash_attention_bwd_dq": 48,
                                           "flash_attention_bwd_dkv": 48})
        if bad:
            raise RuntimeError(f"phase 26b rank {r}: {res}")
    if procs[2].returncode != 0:
        raise RuntimeError(f"the dry run on the card failed "
                           f"({procs[2].returncode}):\n{outs[2][-3000:]}")
    summary = json.loads(next(line for line in reversed(
        outs[2].splitlines()) if line.startswith("{")))
    log(f"  dry run on the card (2 ranks, TP 2, gloo, f32): "
        + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in summary.items() if k != "out"))


def tp_limits_main(torch) -> int:
    """``--tp-limits``: phase 26's references, then phase (b) once as it
    is and once with each planted fault (``plant_tp_fault``), every
    reading printed and none held: the lower and upper readings the limits
    TP_FEAT_REL, TP_LAT_REL and TP_GRAD_REL are set between."""
    from v2ap_torch.ops import flash_attention as fa

    log(f"[tp-limits] card: {card_line()}")
    fa.build_library()
    fa._library()
    tp_dir = tempfile.mkdtemp(prefix="v2ap_chip_smoke_tp_")
    try:
        frames = clip_frames()
        pipe = full_pipeline(torch, "V2A", frame_stride=1)
        tp_references(torch, pipe, frames, tp_dir)
        del pipe
        torch.cuda.empty_cache()
        phase_26_train(torch, tp_dir)
        for fault in TP_FAULTS:
            log(f"[tp-limits] planted fault {fault}: the parts "
                f"{TP_FAULTS[fault]}")
            phase_26_finish(phase_26_start(tp_dir, fault, dry_run=False),
                            check=False)
    finally:
        shutil.rmtree(tp_dir, ignore_errors=True)
    log(card_line())
    return 0


# --------------------------------------------------------------- phase 27

def wav_file(samples, sr: int, fmt: int, bits: int,
             extensible: bool = False) -> bytes:
    """A RIFF WAV of (n, channels) ``samples`` already in the sample type,
    ``fmt`` 1 (PCM) or 3 (IEEE float), as a plain or an EXTENSIBLE "fmt "
    chunk."""
    import struct

    import numpy as np

    ch = samples.shape[1]
    if bits == 24:
        v = samples.astype(np.int32).reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                        1).astype(np.uint8).tobytes()
    else:
        data = samples.tobytes()
    block = ch * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, ch, sr,
                       sr * block, block, bits)
    if extensible:
        head += struct.pack("<HHI", 22, bits, (1 << ch) - 1) + struct.pack(
            "<H", fmt) + bytes.fromhex("000000001000800000aa00389b71")
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def host_walls(fns: dict) -> dict:
    """Host seconds of each route, HOST_WALL_REPS runs each, the routes
    taking turns: name -> every wall."""
    walls = {name: [] for name in fns}
    for _ in range(HOST_WALL_REPS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            walls[name].append(time.perf_counter() - t0)
    return walls


def phase_host_library(torch, frames) -> None:
    """27a: the host library built here, each entry point the port's main
    paths call held against its plain version; the host walls."""
    import numpy as np

    from v2ap_torch import native
    from v2ap_torch.data import audio_io
    from v2ap_torch.models import clip_vit

    t0 = time.perf_counter()
    lib = native.build_library()
    native.lib()
    log(f"  built {os.path.relpath(lib, ROOT)} ({native._CXX} "
        f"{' '.join(native._CXX_FLAGS)}) in {time.perf_counter() - t0:.2f} s")

    # read_wav: each format against the samples it was written from
    rng = np.random.default_rng(27)
    x = rng.uniform(-0.9, 0.9, (16000 * 2, 2))
    plain = {16: (np.int16, 32768.0), 24: (np.int32, 8388608.0),
             32: (np.int32, 2147483648.0)}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fmt, bits, ext in (("pcm16", 1, 16, False),
                                      ("pcm24", 1, 24, False),
                                      ("pcm32", 1, 32, False),
                                      ("float32", 3, 32, False),
                                      ("float32 extensible", 3, 32, True),
                                      ("pcm16 extensible", 1, 16, True)):
            if fmt == 3:
                samples = x.astype(np.float32)
                want = samples
            else:
                kind, scale = plain[bits]
                samples = np.round(x * (scale - 1)).astype(kind)
                want = samples.astype(np.float32) / np.float32(scale)
            path = os.path.join(tmp, "clip.wav")
            with open(path, "wb") as f:
                f.write(wav_file(samples, 16000, fmt, bits, ext))
            got, sr = audio_io.read_wav(path)
            if sr != 16000 or not np.array_equal(got, want.T):
                raise RuntimeError(f"read_wav {label}: not the samples")
    env = 0.2 + 0.7 * np.exp(-((np.arange(24000 * 12) - 0.6 * 288000)
                               / 28800.0) ** 2)
    mono = (env * rng.uniform(-1, 1, env.shape)).astype(np.float32)[None]
    start = native.max_energy_start(mono[0], 320, 750)
    if start != audio_io.max_energy_start_plain(mono, 750):
        raise RuntimeError("max_energy_start: not its plain version's")
    log(f"  read_wav (16-, 24-, 32-bit PCM, float32, EXTENSIBLE) bit-equal "
        f"to the written samples; max_energy_start {start} = the plain "
        f"prefix sum's")

    # geometry: phase 5's frames (already 224) and 1280x720 frames, host
    # library against the card's PIL-exact GEMMs
    hd = np.random.default_rng(28).integers(0, 256, (HD_FRAMES, 720, 1280, 3),
                                            dtype=np.uint8)
    for label, src in (("phase 5's 224x224", frames), ("1280x720", hd)):
        host = clip_vit.preprocess_frames(src, 224)
        card = clip_vit.resize_center_crop(torch.from_numpy(src).cuda(), 224)
        if not np.array_equal(host, card.cpu().numpy()):
            raise RuntimeError(f"clip_preprocess_batch {label}: not the "
                               f"card's resize_center_crop")
    y, uv = clip_vit.pack_yuv420(frames)
    py, puv = clip_vit.pack_yuv420_plain(frames)
    lsb = max(int(np.abs(y.astype(int) - py).max()),
              int(np.abs(uv.astype(int) - puv).max()))
    if lsb > 1:
        raise RuntimeError(f"pack_yuv420: {lsb} LSB from its numpy version")
    log(f"  clip_preprocess_batch at 224 bit-equal to resize_center_crop on "
        f"the card ({len(frames)} frames of 224x224, {HD_FRAMES} of "
        f"1280x720); pack_yuv420 within {lsb} LSB of its numpy version "
        f"({len(frames)} frames)")

    card = card_line()
    walls = host_walls({"native": lambda: clip_vit.pack_yuv420(frames),
                        "numpy": lambda: clip_vit.pack_yuv420_plain(frames)})
    nat, npy = (float(np.median(walls[k])) for k in ("native", "numpy"))
    log(f"  host wall, pack_yuv420 of {len(frames)} frames at 224x224: "
        f"native {nat:.4f} s, numpy {npy:.4f} s ({npy / nat:.2f}x); every "
        f"wall {walls}; {card}")
    hd_dev = torch.from_numpy(hd).cuda()

    def card_gemms():
        clip_vit.resize_center_crop(hd_dev, 224)
        torch.cuda.synchronize()

    def upload():
        torch.from_numpy(hd).cuda()
        torch.cuda.synchronize()

    card_gemms()
    walls = host_walls({"native": lambda: clip_vit.preprocess_frames(hd, 224),
                        "card": card_gemms, "upload": upload})
    nat, gem, up = (float(np.median(walls[k]))
                    for k in ("native", "card", "upload"))
    log(f"  host wall, geometry of {HD_FRAMES} frames 1280x720 -> 224: "
        f"native on the host {nat:.4f} s, the card's float64 GEMMs "
        f"{gem:.4f} s (+ upload {up:.4f} s); every wall {walls}; {card}")
    del hd_dev


def phase_golden_tokenizers() -> None:
    """27b: the committed tokenizer directories against the ids
    ``transformers`` gave for them on the CPU."""
    import numpy as np

    from v2ap_torch.data.hf_tokenizer import load_clap, load_t5

    with open(os.path.join(GOLDEN, "tokenizer_ids.json"),
              encoding="utf-8") as f:
        golden = json.load(f)
    for kind, load in (("t5", load_t5), ("roberta", load_clap)):
        t0 = time.perf_counter()
        ids, mask = load(os.path.join(GOLDEN, "tokenizers", kind))(
            golden["prompts"])
        seconds = time.perf_counter() - t0
        if not (np.array_equal(ids, golden[kind]["input_ids"])
                and np.array_equal(mask, golden[kind]["attention_mask"])):
            raise RuntimeError(f"{kind} tokenizer: not the golden ids")
        log(f"  {kind}: {len(golden['prompts'])} prompts, ids {ids.shape} "
            f"and masks equal to transformers'; {seconds:.3f} s with the "
            f"load")


def phase_prompt_tokenizer(torch, frames, strips) -> None:
    """27b: a V2P pipeline with ``tokenizer_path=`` the golden T5
    directory: a new capture keyed on the prompt's width, whose eager
    warm-up (one CFG eval) the wrappers count, and a bit-equal replay."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import (launch_counts,
                                                reset_launch_counts)

    pipe = full_pipeline(torch, "V2P, golden T5 tokenizer",
                         tokenizer_path=T5_TOKENIZER)
    width = golden_prompt_width()
    ids, mask = pipe.tokenize([PROMPT])
    if ids.shape != (1, width) or width == 64 or not mask.all():
        raise RuntimeError(f"tokenizer_path: ids {ids.shape}, width {width}")

    def gen():
        return pipe.generate(None, PROMPT, steps=25, cfg_strength=2.0, seed=0,
                             piano=True, frames_cache=[(frames, CLIP_S, 1)],
                             strips_cache=[(strips, CLIP_S)])

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    first, _ = gen()
    t_first = time.perf_counter() - t0
    counts = dict(launch_counts)
    keys = [c.key for c in pipe.graphs.captures]
    ctx = [k[5][0] for k in keys]         # the context's (b, L, d)
    # the capturing call: the towers' K2, the warm-up's one CFG eval and
    # the replay that follows the capture
    expect = generate_expect(pipe, len(frames))
    expect["flash_attention_packed"] += k1_expect(pipe) // (25 - 1)
    for name, n in norm_expect(pipe.cfg.model, 1).items():
        expect[name] += n
    if len(keys) != 1 or ctx[0][1] != width or counts != expect:
        raise RuntimeError(f"tokenizer_path: captures {keys}, launches "
                           f"{counts} (expected {expect})")
    t0 = time.perf_counter()
    again, _ = gen()
    t_again = time.perf_counter() - t0
    same = np.array_equal(first, again)
    log(f"  V2P generate, prompt of {width} tokens (FLAN-T5-large, context "
        f"{ctx[0]}): capture {t_first:.3f} s (1 new key; launches {counts}: "
        f"K1 {k1_expect(pipe) // (25 - 1)} in the eager warm-up's CFG eval, "
        f"{m_cross(pipe)} of them the cross-attention at nk = {width}, and "
        f"{k1_expect(pipe)} a replay), replay {t_again:.3f} s, "
        f"bit-equal {same}; finite {bool(np.isfinite(again).all())}")
    if not same or not np.isfinite(again).all():
        raise RuntimeError(f"tokenizer_path generate: bit-equal {same}")
    check_roll(pipe)


def m_cross(pipe) -> int:
    """Cross-attentions (to the prompt's context) in one transformer eval."""
    m = pipe.cfg.model
    return m.depth if m.if_cross_attn else 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--tp-rank" in sys.argv:             # a rank of phase 26b
        arg = sys.argv.index
        return tp_rank_main(
            int(sys.argv[arg("--tp-rank") + 1]), sys.argv[arg("--tp-dir") + 1],
            sys.argv[arg("--tp-fault") + 1] if "--tp-fault" in sys.argv
            else None)
    sys.path.insert(0, ROOT)
    try:
        from v2ap_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: the v2ap_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--tp-limits" in sys.argv:
        return tp_limits_main(torch)
    # each flex_attention yardstick compiles for its own shapes: more than
    # dynamo's default of 8, past which it would quietly time the unfused
    # eager version instead; that fallback fails the run
    import torch._dynamo
    torch._dynamo.config.recompile_limit = 64
    warnings.filterwarnings(
        "error", message="flex_attention called without torch.compile")
    t_start = time.perf_counter()

    log(f"[1/27] build — card: {card_line()}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}; f32 matmul and cuDNN TF32 off")
    t0 = time.perf_counter()
    lib = fa.build_library()
    fa._library()
    log(f"  built {os.path.relpath(lib, ROOT)} from "
        f"{', '.join(src.name for src in fa._SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s")

    log("[2/27] kernels vs plain versions (bf16 in, f32 reference)")
    kern = phase_kernels(torch)
    kern.update(phase_train_kernels(torch))
    log_bwd_more(torch)
    log("[3/27] P1 probe: packed (b, n, h*d) vs (b, h, n, d) + transposes")
    kern["P1"] = phase_probe(torch)
    log("[4/27] small f32 config: card vs CPU")
    phase_small(torch)
    import numpy as np

    frames = clip_frames()
    log("[27a/27] the host library on the card's host: read_wav, "
        "max_energy_start, clip_preprocess_batch, pack_yuv420 against their "
        "plain versions; host walls")
    t0 = time.perf_counter()
    phase_host_library(torch, frames)
    t27 = time.perf_counter() - t0
    # phase 26's exchange files (about 6.3 GB of reference tensors)
    tp_dir = tempfile.mkdtemp(prefix="v2ap_chip_smoke_tp_")
    atexit.register(shutil.rmtree, tp_dir, True)
    log("[5/27] full-width V2A generate (frame stride 1, empty prompt; the "
        "sampler as a captured program)")
    pipe = full_pipeline(torch, "V2A", frame_stride=1)

    def generate_v2a():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    phase_generate(torch, pipe, "V2A generate", generate_v2a,
                   generate_expect(pipe, len(frames)))
    log("[6/27] V2A generate profile")

    def profiled(gen, check=None):
        def run():
            wav, _ = gen()
            if not np.isfinite(wav).all():
                raise RuntimeError("profile: non-finite waveform")
            if check is not None:
                check(pipe)
        return run

    gen_counts = phase_profile(torch, "generate", profiled(generate_v2a),
                               SM90_FWD, generate_expect(pipe, len(frames)),
                               k1_expect(pipe))
    log("[7/27] full-width sampler: captured programs vs eager, same inputs")
    phase_captured(torch, pipe, frames)
    log(f"[8/27] generate_batch: {BATCH} x 10 s clips, frames handed in")
    phase_generate_batch(torch, pipe, frames)
    log(f"[9/27] generate_long: a {LONG_S:.0f} s clip in one batched call")
    phase_generate_long(torch, pipe)
    log(f"[10/27] HTTP server: {BATCH} concurrent POST /v2a")
    phase_http(torch, pipe)
    log("[26a/27] parallelism and the wire on phase 5's pipeline: the "
        "captured sampler deterministic, YUV 4:2:0 tower features, "
        "shard_serving over a world-1 NCCL mesh")
    t0 = time.perf_counter()
    phase_26_serve(torch, pipe, frames, tp_dir)
    t26 = time.perf_counter() - t0
    del pipe
    torch.cuda.empty_cache()
    log("[11/27] full-width V2P generate with a prompt (v2a_default(): frame "
        "stride 3, strip stride 2; FLAN-T5-large, Video2Roll)")
    pipe = full_pipeline(torch, "V2P")
    strips = np.random.default_rng(1).integers(
        0, 256, (int(CLIP_S * FPS), 100, 900), dtype=np.uint8)
    valid = int(pipe.tokenize([PROMPT])[1].sum())
    if valid != PROMPT_TOKENS:
        raise RuntimeError(f"V2P: the prompt gives {valid} tokens, not "
                           f"{PROMPT_TOKENS}")

    def generate_v2p():
        return pipe.generate(None, PROMPT, steps=25, cfg_strength=2.0, seed=0,
                             piano=True, frames_cache=[(frames, CLIP_S, 1)],
                             strips_cache=[(strips, CLIP_S)])

    phase_generate(torch, pipe, "V2P generate", generate_v2p,
                   generate_expect(pipe, len(frames)), check=check_roll)
    roll = pipe.last_roll
    log(f"  roll {tuple(roll.shape)}: min {roll.min().item():.4f}, max "
        f"{roll.max().item():.4f}, mean {roll.mean().item():.4f}")
    log("[12/27] V2P generate profile")
    phase_profile(torch, "V2P generate", profiled(generate_v2p, check_roll),
                  SM90_FWD, generate_expect(pipe, len(frames)),
                  k1_expect(pipe))
    log("[26a/27] strip-half against exact strips on phase 11's pipeline")
    t0 = time.perf_counter()
    phase_26_strips(torch, pipe, strips)
    t26 += time.perf_counter() - t0
    del pipe, roll
    torch.cuda.empty_cache()
    log("[27b/27] the golden tokenizers; a full-width V2P generate with "
        "tokenizer_path= the golden T5 directory")
    t0 = time.perf_counter()
    phase_golden_tokenizers()
    phase_prompt_tokenizer(torch, frames, strips)
    torch.cuda.empty_cache()
    t27 += time.perf_counter() - t0
    log(f"  phase 27: {t27:.2f} s")
    log("[13/27] small train: tiny_test() card vs CPU, then "
        f"{TINY_STEPS} steps")
    phase_small_train(torch)
    log("[14/27] full-width V2A train step, then with remat full and dots")
    trainer, batch = full_trainer(torch)
    train_counts = phase_train(torch, trainer, batch)
    phase_train_remat(torch, trainer, batch, train_counts)
    log("[15/27] train-step profile")

    def train_once():
        loss, _ = trainer.train_step(batch)
        if not torch.isfinite(loss):
            raise RuntimeError("train profile: non-finite loss")

    phase_profile(torch, "train step", train_once, SM90_FWD[1:] + SM90_BWD)
    del trainer, batch, train_once
    torch.cuda.empty_cache()
    log("[26a/27] a fresh full-width CFM: the unsharded sample and step "
        "for 26b; the step deterministic and through a world-1 NCCL mesh")
    t0 = time.perf_counter()
    phase_26_train(torch, tp_dir)
    t26 += time.perf_counter() - t0
    log(f"  phase 26a: {t26:.2f} s")
    root = tempfile.mkdtemp(prefix="v2ap_chip_smoke_")
    try:
        log("[16/27] train from corpora: TrainingPipeline(v2a_default()), "
            f"remat dots, EMA, batch {TRAIN_BATCH} x {TRAIN_LATENTS}")
        tp, batcher = phase_corpus_train(torch, root)
        log("[17/27] resume, save the EMA CFM, load_weights, generate")
        held = {"pipe": tp, "batcher": batcher}
        del tp, batcher
        phase_resume_and_serve(torch, held, root, frames)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    from v2ap_torch import config as C

    log(f"[18a/27] DPO at full width: crossatt3, TrainConfig(dpo=True), "
        f"dropout 0.1, no remat, batch {TRAIN_BATCH} x {TRAIN_LATENTS} with "
        f"rows 6 and 7 a pair")
    trainer, batch = full_trainer(torch, train_cfg=C.TrainConfig(dpo=True),
                                  pair=True)
    phase_dpo(torch, "DPO train step", trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    log(f"[18b/27] crossatt6 (FactorCL) with DPO under remat dots, batch "
        f"{TRAIN_BATCH} x {TRAIN_LATENTS}")
    six = C.variant_preset("crossatt6")
    six = six.replace(model=dataclasses.replace(six.model, remat=True,
                                                remat_policy="dots"))
    trainer, batch = full_trainer(
        torch, cfg=six, train_cfg=dataclasses.replace(six.train, dpo=True),
        pair=True)
    phase_dpo(torch, "crossatt6 DPO + FactorCL step (remat dots)", trainer,
              batch)
    del trainer, batch
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="v2ap_chip_smoke_")
    try:
        log(f"[19/27] reflow: pairs from the full-width teacher, "
            f"{REFLOW_STEPS} distill steps, save_model, load_weights, "
            f"generate(fewstep=2)")
        pipe = phase_reflow(torch, frames, root)
        log("[20/27] the reference layout: a full-width synthetic crossatt3 "
            ".pt, python -m v2ap_torch.convert, load_weights, generate; "
            "crossatt6")
        phase_reference(torch, pipe, frames, root)
        del pipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("[21/27] evaluate: Cnn14 and CLAP card vs CPU; run_batch_eval, python "
        "-m v2ap_torch.evaluate (FAD, IS, KL, CLAP) and python -m "
        "v2ap_torch.inference_v2p from primed caches")
    phase_evaluators(torch)
    root = tempfile.mkdtemp(prefix="v2ap_chip_smoke_")
    try:
        t0 = time.perf_counter()
        phase_eval(torch, root)
        log(f"  phase 21's batch evaluation: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log("[22/27] the other video towers: small f32 card vs CPU; full-width "
        "mixed (ViT-bigG + ViT-L/336 + ConvNeXt-XXLarge + DINOv2-giant, "
        "4608-d) and clip_vit2 generates")
    t0 = time.perf_counter()
    k2_clip_l = phase_towers(torch, frames)
    log(f"  phase 22: {time.perf_counter() - t0:.2f} s")
    log("[23/27] Audeo: trainer steps card vs CPU; full-width Video2Roll and "
        "Roll2Midi training; roll inference, Roll2Midi, synthesis, MIDI, "
        "metrics")
    t0 = time.perf_counter()
    phase_audeo(torch)
    log(f"  phase 23: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    log("[26b/27] TP 2, two ranks sharing the card through gloo over CUDA "
        "tensors, full width: ViT-bigG 64 frames, the 25-step sample, one "
        f"train step ({TRAIN_BATCH} x {TRAIN_LATENTS}), each against the "
        "unsharded port; the multichip dry run beside them; in the "
        "background of phase 24a")
    tp_run = phase_26_start(tp_dir)
    log("[24a/27] weights in: seeded tensors in the published layouts of "
        "ViT-bigG, FLAN-T5-large, EnCodec 24 kHz, DINOv2-giant, "
        "ConvNeXt-XXLarge, ViT-L/336 and Video2Roll; python -m "
        "v2ap_torch.convert; load_weights; generate")
    t0 = time.perf_counter()
    tp_ranks = []

    def finish_26b():
        tp_ranks.extend(phase_26_finish(tp_run))
        shutil.rmtree(tp_dir, ignore_errors=True)
        log(f"  phase 26b: {time.perf_counter() - tp_run['t0']:.2f} s from "
            f"its start (with phase 24a) to its end")

    try:
        int8_counts = phase_24(torch, frames, after_24a=finish_26b)
    finally:
        phase_26_stop(tp_run)     # idempotent; stops them if 24a failed
        log(f"  phase 24 (24a beside 26b): "
            f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_25(torch)
    log(f"  phase 25: {time.perf_counter() - t0:.2f} s")

    main_case = {"K1": "K1 self-attn (2, 800, 16x64)",
                 "K2": "K2 ViT-bigG (64, 16, 257, 104)",
                 "K3": "self-attn (8, 782, 16x64)",
                 "K4": "self-attn (8, 782, 16x64)",
                 "K5": "self-attn (8, 782, 16x64)",
                 "P1": "P1 probe (24, 768, 16x64)",
                 "N1": "N1 audio (1600, 1024), 1 + gamma",
                 "N2": "N2 audio gate (1600, 1024)",
                 "Q1": "Q1 fc1 activations (16448, 1664)",
                 "Q2": "Q2 fc1 (16448, 8192) + bias"}
    src = "v2ap_tpu/ops/flash_attention.py"
    meta = {"K1": ("flash_attention_packed", "flash_fwd_sm90.cu",
                   f"{src}:503"),
            "K2": ("flash_attention", "flash_fwd_sm90.cu", f"{src}:103"),
            "K3": ("flash_attention_lse", "flash_fwd_sm90.cu", f"{src}:116"),
            "K4": ("flash_attention_bwd_dq", "flash_bwd_sm90.cu",
                   f"{src}:151"),
            "K5": ("flash_attention_bwd_dkv", "flash_bwd_sm90.cu",
                   f"{src}:184"),
            "P1": ("flash_bnhd", "flash_fwd_sm90.cu",
                   "scripts/probe_flash_bnhd.py:44"),
            "N1": ("rms_norm", "norms.cu", "none"),
            "N2": ("gated_residual", "norms.cu", "none"),
            "Q1": ("int8_quantize", "quantize.cu", "none"),
            "Q2": ("int8_dequantize", "quantize.cu", "none")}
    counts = {**{k: gen_counts[k] for k in ("flash_attention_packed",
                                            "flash_attention")},
              **{k: train_counts[k] for k in ("flash_attention_lse",
                                              "flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv")},
              "flash_bnhd": kern["P1"]["launches"],
              **{k: gen_counts[k] for k in ("rms_norm", "gated_residual")},
              **{k: int8_counts[k] for k in ("int8_quantize",
                                             "int8_dequantize")}}
    # K2 a second time: its case at CLIP ViT-L/336's shape, the launches of
    # one clip_vit2 generate (phase 22)
    main_case["K2_CLIP_L"] = K2_CLIP_L
    meta["K2_CLIP_L"] = meta["K2"]
    # and a third: TP's local heads, the launches of one rank's sharded
    # ViT-bigG chunk (phase 26b)
    main_case["K2_TP"] = K2_TP
    meta["K2_TP"] = meta["K2"]
    launches = {**{kid: counts[name] for kid, (name, _, _) in meta.items()},
                "K2_CLIP_L": k2_clip_l,
                "K2_TP": tp_ranks[0]["tower_launches"]["flash_attention"]}
    entries = []
    for kid, (name, source, replaces) in meta.items():
        c = kern[kid]["cases"][main_case[kid]]
        entries.append({
            "name": name, "case": main_case[kid], "route": "cuda",
            "source": f"v2ap_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": kern[kid]["max_abs_err"],
            "ms": c["ms"], "graph_ms": c["graph_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    log(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:                # any failed phase: no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
