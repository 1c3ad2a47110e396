#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile]

Drives the port's paths at full width with seeded random weights: the
flagship configs/EfficientConformerCTCSmall.json (batched greedy CTC
inference, the CTC training step), configs/EfficientConformerTransducer
Small.json (batched greedy Transducer decoding, the Transducer training
step), configs/LM-Transformer.json (scoring: eval loss and perplexity;
the LM training step), each with its config's own training_params, beam
search with the configs' decoding_params (the CTC prefix beam with an
n-gram, the Transducer beam with the LM-Transformer and an n-gram, on the
device and on the host, the latter on the growing KV cache), InterCTC,
streaming: sessions over the flagship made causal or limited-context, and
the slot-pool server over both Smalls, then remat, the encoder and decoder
variants no shipped config uses, EfficientConformerCTCMedium made
causal, streamed at head width 135, data parallelism (the flagship's
step over two ranks sharing the card over gloo and over one NCCL rank,
the CLI with -d), tensor parallelism (the flagship's, Transducer Small's
and the LM-Transformer's steps over a model group of two ranks sharing the
card over gloo, the kernels at a rank's head counts) and sequence
parallelism (the flagship's and Transducer Small's steps over a seq group
of two ranks sharing the card over gloo, the rel-pos kernels at a rank's
query rows against every key). Holds
every hand-written kernel on those paths to its plain PyTorch version on
the card. Phases, one line each; any failure exits non-zero:

  1. device     CUDA present; card name and power limit; TF32 off
  2. build      all six kernels, from the sources in this checkout, one
                nvcc each, started together; ptxas registers, spills; the
                rel-pos kernels' shared memory on both routes at the stage
                shapes of all twelve ASR configs and which route takes each,
                the bias kernels' at the LM's widths on both routes (bf16:
                the tensor-core kernels, fp32: the FMA kernels)
  3. kernel     the rel-pos forward kernel vs its plain version at the CTC
                inference shapes (10 s of audio, batch 8, ragged key masks):
                fp32 on the FMA kernel, bf16 on the tensor-core kernel
                (route counters), each vs the fp32 plain version on the
                same inputs; then timed at b128 from CUDA graphs (device
                time) beside eager calls, the plain version, the bound and
                the library (SDPA's memory-efficient kernel on the
                augmented features)
  4. kernel-bwd the rel-pos backward kernels likewise at the CTC training
                shapes (16 s, batch 8); then timed at batch 32, bf16
  5. requests   a ragged batch (2.5 s, 6 s, 10 s) decoded through
                greedy_decode (CTC) in bf16; 15 forward launches, all on the
                tensor-core route (as in every bf16 phase below; every fp32
                slice is all on the FMA route)
  6. slice      full-width fp32 CTC logits through the kernel vs the plain
                version on the card, and vs the CPU
  7. rate       batch 128 x 10 s greedy CTC decode in bf16: audio-s/s
  8. train-slice  one fp32 CTC step (2 x 4 ragged utterances of 4-8 s,
                dropout 0, SpecAugment off), kernels vs plain versions on the
                card and vs the CPU; 15 backward launches per microbatch
  9. train-learns  30 CTC steps on one batch: the loss falls
 10. train-rate the CTC config's own step, 2 x 32 x 16 s, bf16: ms per step,
                audio-s/s, peak memory, launches per step
 10a. dp-slice  data parallelism: two ranks on the one card over gloo, each
                on its 2 rows of train-slice's 2 x 4 utterances under DDP
                and the globally synced BatchNorm, fp32 then bf16, vs the
                one-process step over the global batch (loss and norm 1e-5,
                parameters and statistics 1e-4 in fp32, all 2e-2 in bf16),
                the running statistics equal across the ranks; rel-pos
                launches per rank (a block a microbatch, FMA in fp32, tensor
                cores in bf16)
 10b. dp-rate   one rank over NCCL through DDP on train-rate's step: the
                parameters bit for bit those of the step without DDP; ms a
                step with and without DDP in turns, beside train-rate's
 10c. tp-kernel  tensor parallelism's shapes: the rel-pos forward and
                backward at the flagship's 16 s stage shapes on a rank's 2
                and 1 heads, the bias forward and backward at the LM's
                causal shape on 6 and 3 heads, vs their plain versions, fp32
                on the FMA route and bf16 on the tensor cores (route
                counters); the shared memory of each route at each stage
 10d. tp-slice  two ranks on the one card over gloo in one model group (data
                1 x model 2): the flagship at full width, one fp32 and one
                bf16 step, Transducer Small's fp32 step and the
                LM-Transformer's fp32 step (all but the flagship's fp32 step
                with its loss in fp32 one block a stage, the LM one block),
                over 2 x 4 ragged rows, vs the
                one-process step at [dp-slice]'s gates; replicated parameters
                bit for bit equal across the ranks; launches a rank and a
                step (rel-pos 30 / 30 on 2 heads, bias 24 / 24 on 6), the
                model group's all-reduces and all-gathers a step (gloo's
                all-gather takes the card's tensors); the fp32 norms also
                against the one-process step with its vocabulary product
                split into the model group's column GEMMs (norm_rel_split)
 10d'. tp3-slice three ranks on the card over gloo, data 1 x model 3:
                Conformer CTC Small (every layer replicated) fp32 and bf16,
                EfficientConformer CTC Small (its fc replicated) fp32, one
                block a stage, vs the one-process step at [tp-slice]'s gates
                (the fp32 losses in float64); the replicated parameters
                counted against placement_of and bit for bit equal
 10e. tp-cli    -m training --model_parallel 2 on one GPU refused with the JAX
                package's message (scripts/torch_tp_multigpu.py runs it on
                four GPUs)
 10f. sp-kernel sequence parallelism's shapes: both rel-pos kernels at the
                flagship's 16 s stage shapes (padded by sp_pad_align) with
                the query rows of seq rank r of 2 (offsets 0, T/2) and of 4
                (0, T/2, 3T/4) against all T keys, the grouped stage's rows
                the groups covering a rank's frames (404 frames a rank at
                seq 2: not a multiple of 3), vs their plain versions at
                [kernel]'s gates, fp32 on the FMA route and bf16 on the
                tensor cores (route counters); both bias kernels
                at the causal 4-head Large's stage shapes (8 s) at seq rank
                r of 2's rows (from 0 and N/2) against all N keys under the
                causal bias's rows, at [lm-kernel]'s gates (sp-kernel-bias)
 10g. sp-slice  two ranks on the one card over gloo in one seq group (data 1
                x seq 2): the flagship at full width (one block a stage since
                PR 20), one fp32 and one bf16 step, and Transducer Small's
                fp32 step (one block a stage), over 2 x 4 ragged
                utterances of 4-8 s padded by sp_pad_align, and the
                flagship's fp32 step at a length no point of whose encoder
                divides by 2 (every point replicated), vs the one-process
                step at [tp-slice]'s gates; the ranks' parameters bit for
                bit equal; a rank's rel-pos launches a step, the seq group's
                all-gathers, halos and reduce-scatters, and each rank's
                peak memory beside the one-process step's
 10h. sp-cli    -m training --seq_parallel 2 on one GPU refused with the JAX
                package's message (scripts/torch_sp_multigpu.py runs it on
                four GPUs)
 10i. sp-skew-slice  two ranks on the card over gloo, data 1 x seq 2:
                [causal-wide-slice]'s causal 4-head Large, one block a stage,
                through the bias kernels at each rank's rows (the rel scores
                skewed at its row offset; head 270 chunked), an fp32 (loss in
                float64) and a bf16 step vs the one-process step at
                [sp-slice]'s gates; launches and routes a rank, the seq
                group's exchanges
 11. t-kernel   both rel-pos kernels vs their plain versions at Transducer
                Small's 16 s stage shapes (head widths 75/35/50, rel widths
                100/140/200, batch 8, ragged key masks), fp32 and bf16, as
                in 3 and 4
 12. rnnt-kernel  both RNN-T lattice kernels vs their plain versions at the
                Transducer's training shape (B 16, T 201, U+1 91, ragged
                lengths with f_len = T, y_len = 0 and y_len = U; whether
                they are equal bit for bit there) and at U+1 = 150 (more
                than 128 threads a block); both timed at the training shape
                (device time from a CUDA graph, and per eager call) beside
                the plain versions and the bound
 12a. rnnt-long-kernel  both RNN-T kernels past 1,024 label positions, on
                their strip routes (a strip of 2, 4 or 8 positions a thread
                in registers, or a wider one read back from the output),
                vs their plain versions at (B, T, U+1) (2, 64, 1,025), (2,
                64, 2,048), (1, 48, 3,700), (1, 32, 8,192) and (1, 16,
                32,768): across the ring-depth edges and past the strips
                held in registers; the geometry, ptxas' registers and
                spills of each instantiation, whether they are equal bit for
                bit, ms (CUDA graphs) beside the plain versions and the bound
 12b. t-long-eval  Transducer Small's evaluation loss (Trainer.eval_loss, the
                CLI's --eval_loss and the per-epoch validation loss) at full
                width in its own mixed precision on one 300 s utterance
                carrying 1,100 labels: the lattice (1, 3,751, 1,101) on the
                strip route, launches, the loss vs the plain versions on the
                gathered log-probs (and the backward on them), ms, the
                encoder's and the loss's share, peak memory
 13. t-requests the ragged batch decoded by the Transducer in bf16 with the
                label-looping greedy loop: 15 forward launches, tokens equal
                to the frame-synchronous loop's
 14. t-slice    full-width fp32 lattice logits through the kernels vs the
                plain versions on the card and vs the CPU; greedy tokens
                through the kernels equal to those through the plain versions
 15. t-rate     batch 16 x 10 s Transducer greedy decode in bf16: audio-s/s,
                tokens per utterance, loop iterations
 16. t-train-slice  one fp32 Transducer step (2 x 4 ragged utterances of
                4-8 s, labels of 10-30 tokens, dropout 0, SpecAugment and VN
                off), kernels vs plain versions on the card and vs the CPU
 17. t-train-learns  30 Transducer steps on one batch: the loss falls
 18. t-train-rate  the Transducer config's own step, 4 x 16 x 16 s with
                90-token labels, bf16: ms per step, audio-s/s, peak memory,
                launches per step (4 / 8 RNN-T: the backward's four calls
                launch two kernels each; 60 / 60 rel-pos); one more
                step with variational noise on
 19. lm-kernel  both bias-attention kernels vs their plain versions, fp32
                (the FMA kernels) and bf16 (the tensor-core kernels, by the
                route counters): at the LM's shape (B 8, H 12, N 101, dh 64)
                with its causal + padding + rel-pos bias and ragged lengths;
                a (B, 1, Nq, Nk) and a (1, H, Nq, Nk) bias, a key mask,
                dqk 90 / dv 70 at N 130, one fully masked row; then both
                timed at B 64, bf16, beside the plain versions, the bound and
                scaled_dot_product_attention, from CUDA graphs (device time)
                and per eager call (host time included)
 20. lm-slice   full-width fp32 LM-Transformer logits of 8 ragged sequences
                (10-100 tokens) through the kernel vs the plain version on
                the card, and vs the CPU; 12 forward launches, all on the
                FMA route
 21. lm-score-rate  eval loss and perplexity of 64 x 100 tokens (+ the
                blank) in bf16: ms per batch, tokens/s, 12 launches a batch,
                all on the tensor-core route
 22. lm-train-slice  one fp32 LM step (2 x 4 ragged sequences, dropout 0),
                kernels vs plain versions on the card and vs the CPU; every
                launch on the FMA route
 23. lm-train-learns  30 LM steps on one batch: the loss falls
 24. lm-train-rate  the LM config's own step, 5 x 64 x 100 tokens, bf16,
                dropout 0.1: ms per step, tokens/s, peak memory, launches per
                step (60 / 60, all on the tensor-core route), model FLOPs
                over the bf16 peak

 25. ngram-device  the device n-gram scorer vs the host ArpaLM on seeded
                random walks over a synthetic 6-gram at the shipped files'
                shape (tests/ngram_synth.py: 256 tokens, ~360k entries):
                scores <= 1e-6, nodes equal; entries, bytes on the card, ms
                a lookup batch of the CTC beam's per-frame shape
 26. ctc-beam   CTC Small, bf16, 32 ragged utterances of up to 10 s, the
                device prefix beam at W 16 with the 6-gram (alpha 0.3, beta
                1): on seeded peaky log-probs the host C++ beam's tokens; on
                the model's log-probs card vs CPU tokens equal or best
                scores within 1e-4 (near-ties counted), agreement with the
                C++ beam counted; ms a batch, audio-s/s, the beam's share,
                rel-pos launches (15), host reads before the result (0)
 27. t-beam     Transducer Small with LM-Transformer (lm_weight 1) and a
                synthetic 6-gram over 1000 tokens fused, W 16: card vs CPU
                at 2 utterances of 2 and 1.5 s in fp32, Graves and ref_topk
                routing, tokens equal or final scores within 1e-4 (counted;
                the CPU side computed beside the card's phases in a process
                started after the build, on weights and audio of the same
                digest); then 4 x 10 s with the bf16 encoder: ms a batch, audio-s/s,
                fast and slow frames, pops, host reads, rel-pos launches
                (15), peak memory
 27a. lm-step-kernel  the bias forward kernel vs its plain version at one
                query row, the growing-cache LM step's shape (B 1 and 16, H
                12, dh 64, Nk 1-1025 across the 64-key tile edges, past the
                main path's longest cache), fp32 and bf16 (counted on the
                tensor cores); [lm-step-kernel-time]: B
                1, Nk 100, fp32 from CUDA graphs beside the plain version,
                SDPA with the bias as its mask and the bound
 27b. growing-cache  LM-Transformer at full width, fp32: 40 tokens stepped on
                the growing KV cache equal the fixed-capacity step, the
                teacher-forced forward and the CPU's steps (<= 1e-4); 12
                bias launches a step
 27c. t-host-beam  the host Transducer beams (ECF_HOST_BEAM=1): Transducer
                Small with LM-Transformer through beam_search (the growing
                cache) and with LM-RNN through beam_search_batched, the
                6-gram over 1000 tokens, W 4, 2 utterances of 2 and 1.5 s:
                card vs CPU (the CPU side as [t-beam]'s) and host vs device
                beam: tokens equal or scores within 1e-4 (counted); then one
                4 s utterance at W 16 with
                LM-Transformer: ms a batch, pops, ms a pop, bias launches (12
                a pop), rel-pos launches (15), the longest cache, and the
                kernel vs its plain version at that cache length
 28. stream-kernel  the bias forward kernel vs its plain version at the three
                stage shapes of the flagship made causal (left context 64)
                on a serving window (history 64, chunk 16, lookahead 4: 88
                frames) at 32 slots of ragged lengths, fp32 and bf16, with
                the error on the fully masked rows (past a row's length plus
                the left context) on its own and against the mean of V;
                [stream-kernel-time]: each shape timed in bf16 from CUDA
                graphs beside the plain version, SDPA with the bias as its
                mask and the bound
 29. stream-exact  the flagship made causal (left context 16), then
                limited-context (left 16, right 2) at the suggested
                lookahead: [stream-exact-kernel] holds the bias kernel to
                its plain version at each session's window shapes, two rows,
                fp32 and bf16; then two ragged rows streamed in fp32 through
                StreamingEncoderSession at the suggested history in uneven
                pushes: the streamed logits equal the batch forward on the
                zero-padded utterance within 1e-3 (the limited encoder's
                last lookahead frames apart: fully masked rows past the end
                average V over the padding, and the JAX package's streamed
                tail leaves its batch forward by as much); 15 bias launches
                a window, no rel-pos launch
 30. serve-slice  [serve-kernel-ctc], [serve-kernel-transducer]: the rel-pos
                forward kernel vs its plain version at the serving window's
                stage shapes over 4 and 32 rows, fp32 and bf16; then
                StreamingServer over the full-context flagship (CTC) and
                Transducer Small, bf16, history 64, chunk 16, lookahead 4:
                12 streams of 3-12 s through 4 slots, staggered pushes and
                late submits; every stream's frames within 0.1 (CTC
                logits) / 0.3 (Transducer encoder frames) of the
                single-stream session's, the streams whose tokens
                differ and the CTC frames whose argmax differs counted;
                rel-pos launches, all on the tensor cores, and no bias launch
 31. serve-rate  serving_bench.py's defaults (32 slots, 96 streams of 10 s)
                for both decoders, max_windows_per_tick None and 2: after a
                warm-up pass, 5 timed passes of the 96
                streams: audio-s/s (median, min, max over the passes), tick
                p50/p95 over their
                ticks; then one pass in sync debug mode (host syncs a tick)
                and one profiled (device idle share)

 32-40. the CLI (``python -m efficientconformer_torch.main``) driven in this
                process at the configs' published widths and depths, on a
                synthetic LibriSpeech tree written under build/ (removed
                after); only the dataset, tokenizer and callback paths are
                redirected, and the epochs set:
      cli-data  128 training utterances of 8.5-16 s, 8 dev and 8 test of
                8-16 s (seeded noise, one of each split as FLAC, transcripts
                from a seeded lexicon) and a 700-line LM corpus; byte sizes;
                the FLAC files through the native decoder, bit for bit
      cli-train  CTC Small: --create_tokenizer (native BPE trainer) -p,
                2 epochs of 2 steps with validation WER and a checkpoint
                each; 30 / 30 tensor-core rel-pos launches every step,
                validation's apart; ms a step through the CLI beside
                [train-rate]'s, the rel-pos table cache's misses; then the
                loader's host ms a batch at CTC Small's 2 x 32
      cli-buckets  the rel-pos table caches over the lengths a LibriSpeech
                epoch pads to (8 training and 8 evaluation buckets), two
                epochs: misses, rebuilds after an eviction, ms a miss
      cli-resume  checkpoints_1.ckpt into a fresh trainer bit for bit (the
                parameters, BatchNorm buffers, Adam state and step saved);
                -i 1 runs epoch 2, its steps profiled: device ms a step and
                the idle share of [cli-train]'s second epoch
      cli-test  test-clean -i 2 --gready: the WER line, predictions string
                for string greedy_decode's over the same loader batches
      cli-dp    -d (one rank over NCCL, DDP): one epoch of 2 steps with
                validation and a checkpoint, whose test-clean WER with -d
                equals the one-process run's; -d --world_size above the GPU
                count refused
      import-ckpt  an original-style checkpoint of the flagship's seeded
                weights and a pickled tokenizer through ``python -m
                efficientconformer_torch.import_checkpoint --with-tokenizer``,
                then test-clean -i 9 --gready: predictions those of the same
                weights loaded in-process
      cli-swa   --swa --swa_epochs 1 2: parameters the checkpoints' mean
                (<= 1e-6), BatchNorm statistics refreshed, no optimizer
      cli-eval-time  eval_time, eval_time_encoder
      profiler  eval_time --profiler: the top-10 table of kernels by device
                time names the rel-pos forward kernel; the trace under
                callback_path/profile/
      cli-transducer  Transducer Small: its own tokenizer and manifests,
                1 step (RNN-T 4 / 8 and rel-pos 60 / 60 launches) with
                validation, test-clean --gready, eval_time_decoder
      cli-lm    LM-Transformer: 1 step on the corpus (bias 60 / 60, all on
                the tensor cores) with lm_mode validation, validation-clean
      cli-beam  test-clean without --gready: CTC Small with the 6-gram at
                the redirected ngram_path, and Transducer Small with
                --initial_epoch_lm 1 ([cli-lm]'s checkpoint) and the 1000-token
                6-gram; each prints its Beam Search WER, and its predictions
                equal the device beam's called directly on the same batches

 41. interctc-step  the flagship as InterCTC (taps after blocks 4 and 7): one
                fp32 step through the kernels vs the plain versions and the
                CPU (one block a stage, taps after its two strided
                blocks); the config's bf16 step at 2 x 32 x 16 s: ms a step
                beside [train-rate]'s, 30 / 30 rel-pos launches on the
                tensor cores, device ms and host syncs a step beside the
                CTC step's
 42. remat      encoder_params remat "full" and "dots" on the flagship:
                [remat-fp32] one fp32 step at [train-slice]'s shape with
                dropout 0.1 and SpecAugment on equal to the step without
                remat (loss, gradients, BatchNorm statistics within 1e-5
                relative, the generator's state equal); then the config's
                bf16 step at [train-rate]'s 2 x 32 x 16 s with remat off,
                full and dots (within 2e-2 of each other): ms a step, peak
                memory, rel-pos launches a step (60 / 30 under remat: the
                recompute runs the forward kernel again)
 43. variants   CTC Small's widths (one block a stage since PR 20) with one
                change each: even G
                [2, 1, 1], local attention (att_kernel_size 8), strided
                attention (att_stride 2), absolute attention, linear
                attention, and the Conv1d, Conv2dPool and VGG subsamplings:
                fp32 logits of 4 ragged utterances through the kernels vs
                the plain versions on the card and vs the CPU (<= 1e-3),
                the bias and rel-pos launches each takes; for those on the
                bias kernels one fp32 step vs the plain versions and a bf16
                forward on the tensor-core route vs the plain versions on
                the same bf16 model (<= 2e-2 of the largest logit); then
                Transducer Small with a 2-block Conformer decoder: lattice
                (fp32, and bf16 vs plain), one step, greedy tokens equal to
                the plain versions', the device beam; [variants-greedy]:
                the greedy loop's ms a decoder step beside the RNN
                decoder's
 44. wide-kernel  both bias kernels vs their plain versions at head widths
                135 (causal EfficientConformer Medium/Large stage 1) and 256
                at Medium's stage-1 serving-window shape (32 slots, H 4),
                fp32 and bf16 (tensor cores); [wide-kernel-time]: each timed
                in bf16 from CUDA graphs beside the plain version, SDPA with
                the bias as its mask and the bound
 45. stream-medium  EfficientConformerCTCMedium made causal (left context 16)
                streamed in fp32 as [stream-exact]: [stream-medium-kernel]
                at its window shapes, then the streamed logits within 1e-3
                of the batch forward

 46. wide-fp32-kernel  both rel-pos kernels on the fp32 FMA route at the 16 s
                stage shapes of the Medium and Large encoders wider than the
                flagship's (a head over 128, or dh + D over 416; B 2) vs
                the plain versions (forward 1e-4, gradients 1e-4 relative),
                each call counted on the fp32 route; [wide-fp32-kernel-time]:
                each direction timed from CUDA graphs beside the bf16 route,
                SDPA's fp32 math path on the augmented features, the plain
                version and the fp32 bound
 47. wide-fp32-slice  one fp32 training step of EfficientConformer CTC
                Medium and Large, Conformer CTC Large and EfficientConformer
                Transducer Medium at published widths, one block a stage
                since PR 20 (2
                utterances of 16 and 8 s, dropout 0, SpecAugment off) vs
                the plain versions on the card (loss 1e-4, gradients 1e-3,
                the gradient norm 1e-4 with the loss in float64 on both
                sides): ms a step, peak memory, rel-pos launches (a block a
                direction, all fp32)
 48. wider-kernel  both rel-pos kernels, fp32 and bf16, at widths past the
                kernels that hold [qu | A] whole or a 256-wide head (B 2):
                the 16 s stage shapes of the two encoders of [wider-slice]
                that reach a wide route, one of them at a seq rank's rows
                (Nq = Nk / 2 from row Nk / 2), the four shapes the wrapper
                refused before (257/64, 272/544, 150/64, 64/4,000) and
                512/1,024 at H 4, N 201: vs the plain versions (fp32 1e-4,
                gradients 1e-4 relative; bf16 2e-2, bitwise repeatable),
                each call counted on the route ``route`` names;
                [wider-kernel-time]: each direction and type on a wide route
                timed from CUDA graphs beside the plain version, SDPA on the
                augmented features (bf16 memory-efficient, fp32 math) and
                the bound
 49. wide-bf16-slice  EfficientConformer CTC Medium and Large and
                EfficientConformer Transducer Medium at published widths,
                heads and depth in bf16 (mixed_precision as shipped): one
                training step (2 utterances of 16 and 8 s, dropout 0,
                SpecAugment off, VN off) and one greedy batch vs the plain
                versions on the card: loss, norm and statistics within 2e-2
                relative, the gradients no farther from the fp32 step's than
                1.25x the plain versions' bf16 ones over all parameters and
                3x for each parameter; CTC logits within 2e-2 of the largest,
                Transducer frames within 0.3; every launch on the
                tensor-core kernels that hold [qu | A] whole
 50. wider-slice  EfficientConformer CTC Large at 4 heads (heads 270 / 128 /
                180) and Conformer CTC Large at width 1,024 (8 heads of
                128, rel width 1,024; 6 of its 18 blocks), built from the
                shipped configs with one field changed (printed): a bf16 and
                an fp32 training step and a bf16 greedy batch vs the plain
                versions, every launch counted on its route, the wide ones
                where ``route`` names them
 51. widest-kernel  both bias kernels on their chunked routes (past a width of
                256, bf16 padded to 16) vs their plain versions, fp32 and
                bf16, at (dqk, dv) 257, 270, 272, 384, 512, 1,024 (each both
                ways), 270/135, 64/512, 512/64: at the causal 4-head Large's
                stage-1 serving window (32 slots, H 4, N 118) with its causal
                window bias, a key mask, a head-broadcast bias and none, and
                at one query row against 100 / 513 / 1,025 keys (B 1, H 12);
                the backward with and without dS; each call counted on the
                route ``route`` names, held to the compiled kernel files' own
                choice and sizes; [widest-kernel-time]: each width at that
                window and at the training step's stage 1 (2 x 8 s), forward
                and backward, bf16 and fp32, from CUDA graphs beside the
                plain version, SDPA with the bias as its mask (fp32: its
                math path) and the bound
 52. causal-wide-slice  EfficientConformer CTC Large at 4 heads made causal
                (left context 64; heads 270 / 128 / 180) at published widths
                and depth: an fp32 and a bf16 training step (2 x 4 ragged
                utterances of 4-8 s, dropout 0, SpecAugment off) vs the plain
                versions on the card at [wide-fp32-slice]'s and
                [wide-bf16-slice]'s gates, then a bf16 and an fp32 stream
                through StreamingCTC at the serving geometry over two
                utterances (12 and 9 s), logits and tokens vs the same stream
                through the plain versions; every bias launch counted by
                width and route (head 270 on the chunked kernels both ways);
                ms a step, ms a window step, peak memory
 53. contextnet ContextNetSubsampling (80 mels, 240 features, kernel 5) on 2 x
                10 s of features, fp32 on the card vs the CPU, train and
                eval BatchNorm

Then one JSON line with each kernel's launches, error, times and bound (the
rel-pos entries also with their bf16 error, tensor-core launches and eager
per-call ms, the forward's with ``beam_launches`` of [ctc-beam] and
[t-beam] and the rel-pos launches of [t-host-beam]; the rel-pos entries
with ``interctc_launches`` of [interctc-step]'s bf16 step; the bias
forward's with ``host_beam_launches`` of [t-host-beam] and [lm-step-kernel-
time]'s times as ``step_*_ms``; the rel-pos and bias forward entries with ``serve_launches``
of [stream-exact], [serve-slice] and [serve-rate], each counted from 0
just before the phase's server or sessions run, the bias forward's with
[stream-kernel-time]'s summed times as ``stream_*_ms``; every entry with
``cli_launches``, its launches over the CLI's runs, each counted from 0;
the rel-pos entries with ``remat_launches`` of [remat]'s remat "full"
step; the bias entries with ``variants_launches`` of [variants]' fp32
steps and [wide-kernel-time]'s rows as ``wide_{135,256}_*_ms``, the
forward's with ``stream_medium_launches``; the rel-pos entries with
``dp_launches`` of [dp-slice], over both ranks and steps, and of
[dp-rate]'s counted DDP step; the rel-pos and bias entries with
``tp_launches`` of [tp-slice] and of [tp3-slice], over the ranks and steps, and
``tp_kernel_max_err``, [tp-kernel]'s largest fp32 error; the rel-pos and
RNN-T entries with ``wide_fp32_launches`` of [wide-fp32-slice], the
rel-pos entries with ``wide_fp32_max_err`` and [wide-fp32-kernel-time]'s
sums as ``wide_fp32_*_ms``, and their launches in [wide-bf16-slice] and
[wider-slice]; then one entry a direction for the wide routes: launches
their wide launches in [wider-slice], times [wider-kernel-time]'s sums
over the wide rows; then one entry a direction for the bias kernels'
chunked routes: launches their chunked launches in [causal-wide-slice],
the error [widest-kernel]'s, times [widest-kernel-time]'s sums; the bias
entries with ``sp_launches`` of [sp-skew-slice] and ``sp_kernel_max_err``
of [sp-kernel]'s bias rows, the chunked ones with ``sp_skew_launches``), and last
{"ok": true, "device": {...}}. With
--profile it also prints a torch.profiler device-time breakdown of one
batch or step of each path, the beams included.
There is no CPU path: without a GPU the script exits non-zero and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import contextlib
import copy
import hashlib
import io
import itertools
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time
import traceback
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = "configs/EfficientConformerCTCSmall.json"
ASR_CONFIGS = [f"configs/{arch}{head}{size}.json" for arch in ("Conformer", "EfficientConformer")
               for head in ("CTC", "Transducer") for size in ("Small", "Medium", "Large")]
T_CONFIG = "configs/EfficientConformerTransducerSmall.json"
LM_CONFIG = "configs/LM-Transformer.json"
SEED = 0
SAMPLE_RATE = 16000
REQUEST_SECONDS = (2.5, 6.0, 10.0)
CHECK_BATCH = 8
TIME_BATCH = 128
TIME_SECONDS = 10.0
KERNEL_FP32_TOL = 1e-4       # fp32 kernel vs fp32 plain: summation order only
KERNEL_BF16_TOL = 2e-2       # bf16 output rounding (8 mantissa bits) of O ~ 1
SLICE_TOL = 1e-3             # fp32 logits after 15 blocks
SLICE_ARGMAX_AGREEMENT = 0.999
TRAIN_SECONDS = 16.0         # the config's train_audio_max_length (256000 samples)
TRAIN_BATCH = 32             # the config's batch_size; accumulated_steps 2
GRAD_TOL = 1e-4              # fp32 backward kernel vs plain, relative to max(max|.|, 1):
                             # per-token gradients and the batch sums dW, ddelta, dbias
GRAD_BF16_TOL = 2e-2         # bf16: gradients rounded to bf16, Di from the bf16 O
# The rel-pos tensor-core kernels also round W, delta, the tables, qv, A, P,
# dS and dpq to bf16 where the TPU kernel does; they are held within the two
# bf16 bounds above to the fp32 plain version on the same bf16 qu, k and v.
TRAIN_LOSS_RTOL = 1e-4       # fp32 step, kernels vs plain versions, and card vs CPU
TRAIN_GRAD_TOL = 1e-3        # per parameter, relative to max(max|g|, 1): fp32 sums in
                             # another order through 15 blocks and 31 BatchNorms
TRAIN_STATS_TOL = 1e-4       # BatchNorm running statistics, relative to max(|x|, 1)
LEARN_STEPS = 30
LEARN_RATIO = 0.7            # the last loss of train-learns below 0.7 x the first
MAX_CONSEC = 5               # max_consec_dec_steps of the greedy Transducer loops
T_RATE_BATCH = 16
RNNT_LOSS_RTOL = 1e-5        # RNN-T kernels vs plain: the same fp32 recursion, same order
RNNT_GRAD_TOL = 1e-5         # their gradients are probabilities, at most 1
RNNT_WIDE = (4, 60, 150)     # (B, T, U+1) with U+1 > 128: more than 128 threads a block
# [rnnt-long-kernel]: (B, T, U+1) past one thread a label position: strips of
# 2 (1,025, 2,048), 4 past the ring of 8 (3,700: 7), 8 (8,192: a ring of 3)
# and read back (32,768); T short where U+1 is long, so the plain versions stay quick
RNNT_LONG_SHAPES = ((2, 64, 1025), (2, 64, 2048), (1, 48, 3700), (1, 32, 8192), (1, 16, 32768))
T_LONG_SECONDS = 300.0       # [t-long-eval]: one long-form utterance (3,751 encoder frames)
T_LONG_LABELS = 1100         # carrying 1,100 labels (U+1 1,101, ~3.7 BPE-1000 tokens a second)
LM_CHECK_BATCH = 8
LM_TIME_BATCH = 64           # the LM config's batch_size
LM_SLICE_LENGTHS = (10, 100)  # ragged sequences of 10..100 tokens
BF16_PEAK = 989e12           # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet, 700 W)
FP32_PEAK = 67e12            # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s
# the CLI phases' synthetic LibriSpeech: split -> (utterances, shortest and
# longest seconds). 128 training utterances of 8.5-16 s fill two of CTC
# Small's 2 x 32 batches (every one lies above the lower of the loader's two
# length buckets) and two of the Transducer's 4 x 16.
CLI_SPLITS = {"train-clean-100": (128, 8.5, 16.0), "dev-clean": (8, 8.0, 16.0),
              "test-clean": (8, 8.0, 16.0)}
CLI_LM_LINES = 700           # LM-Transformer's step takes 5 x 64 lines
CLI_WORKERS = 8              # the CLI's default -j
DEV_MAX_SECONDS = 33.0       # an evaluation split's longest utterance, from which its
                             # loader cuts its 8 buckets (assumed: no LibriSpeech here)
SWA_TOL = 1e-6               # SWA parameters vs the mean of the checkpoints
NGRAM_ORDER = 6              # the shipped 6gram_256.arpa / 6gram_1000.arpa's order
NGRAM_TOL = 1e-6             # device n-gram scores vs the host ArpaLM: the same fp32 sums
NGRAM_WALKS = (4096, 24)     # random token walks (count, steps) of [ngram-device]
BEAM = 16                    # every shipped config's beam_size
CTC_BEAM_BATCH = 32          # [ctc-beam]: 32 ragged utterances of up to 10 s
T_BEAM_BATCH = 4             # [t-beam]: 4 x 10 s (the LM cache is 47.3 MB a hypothesis)
T_BEAM_CHECK = (4.0, 3.0)    # [t-beam]'s card vs CPU check: 2 utterances, seconds
BEAM_REF_THREADS = 4         # CPU threads of the process that computes the beams' CPU sides
BEAM_SCORE_TOL = 1e-4        # where two beams' tokens differ, their best scores must be this near
# [lm-step-kernel]: Nk across the 64-key tile edges, past [t-host-beam]'s longest cache (~750)
LM_STEP_KEYS = (1, 2, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 511, 512, 513, 767, 768,
                769, 1023, 1024, 1025)
LM_STEP_TIME_KEYS = 100      # its timed shape: one query row against 100 cached keys
LM_CACHE_TOKENS = 40         # [growing-cache]: tokens stepped on the growing cache
LM_RNN_CONFIG = "configs/LM-RNN.json"
T_HOST_BEAM_CHECK = (4.0, 3.0)  # [t-host-beam]'s card vs CPU check: 2 utterances, seconds
T_HOST_BEAM_W = 4            # its beam
T_HOST_BEAM_SECONDS = 4.0    # its main path: one utterance at the config's beam
INTERCTC_TAPS = (4, 7)       # [interctc-step]: the strided block 4 and block 7 of stage 2
INTERCTC_CUT_TAPS = (0, 1)   # its fp32 check at one block a stage: the two strided blocks
MEDIUM_CONFIG = "configs/EfficientConformerCTCMedium.json"
REMAT_FP32_TOL = 1e-5        # remat vs none, fp32: the same arithmetic, recomputed
REMAT_BF16_TOL = 2e-2        # the same in bf16 at the config's own step
VARIANT_BF16_TOL = 2e-2      # [variants]' bf16 logits, kernels vs plain versions on the same
                             # bf16 model and inputs, relative to max(max|logits|, 1): the
                             # logits are bf16, whose step is 0.0156 at 2-4 (H100 readings:
                             # 0.0312-0.0317 max |diff|, 0.0124-0.0138 relative, on the CTC
                             # variants; 0.0176, 0.0107 on the Conformer decoder's lattice)
SERVE_GEOMETRY = {"chunk_frames": 16, "history_frames": 64, "lookahead_frames": 4}
                             # serving_bench.py's defaults: 66 / 18 / 4 after alignment, an
                             # 88-frame (7.03 s) window
STREAM_SLOTS = 32            # [stream-kernel]: a window step over 32 slots
STREAM_LEFT = 64             # left_context of the causal flagship in [stream-kernel]
STREAM_EXACT_LEFT = 16       # [stream-exact]'s left_context: a 272-frame suggested history
STREAM_TOL = 1e-3            # fp32 streamed vs batch logits after 15 blocks (as SLICE_TOL)
SERVE_SLOTS = 4              # [serve-slice]: 12 streams of 3-12 s through 4 slots
SERVE_STREAMS = 12
SERVE_SECONDS = (3.0, 12.0)
SERVE_FRAME_TOL = {"ctc": 0.1, "transducer": 0.3}
                             # bf16 server (4 rows) vs single-stream frames, max |diff|: about
                             # 3x the largest readings on the H100 (CTC logits 0.0343,
                             # Transducer encoder frames 0.109)
RATE_SLOTS = 32              # [serve-rate]: serving_bench.py's 32 slots, 96 streams of 10 s
RATE_STREAMS = 96
RATE_SECONDS = 10.0
RATE_PASSES = 5              # timed passes of the 96 streams: 15 ticks uncapped (3 a pass)
DP_RANKS = 2                 # [dp-slice]: two ranks on the one card, over gloo
DP_LOSS_RTOL = 1e-5          # [dp-slice] fp32 loss and gradient norm vs the one-process step
DP_FP32_TOL = 1e-4           # its fp32 parameters and BatchNorm statistics, relative to
                             # max(|x|, 1): the global batch's sums in another order
DP_BF16_TOL = 2e-2           # the bf16 step's loss, norm, parameters and statistics
DP_TIMEOUT = 300             # seconds for [dp-slice]'s two ranks
TP_RANKS = 2                 # [tp-slice]: two ranks on the one card over gloo, one model group
TP_HEADS = (2, 1)            # [tp-kernel]: the flagship's heads a rank at model 2 and 4
TP_LM_HEADS = (6, 3)         # and the LM-Transformer's
TP_TIMEOUT = 420             # seconds for [tp-slice]'s ranks
TP3_RANKS = 3                # [tp3-slice]: three ranks on the one card over gloo, one model group
TP3_CONFIG = "configs/ConformerCTCSmall.json"   # width 176: every layer replicated at model 3
SP_RANKS = 2                 # [sp-slice]: two ranks on the one card over gloo, one seq group
SP_KERNEL_RANKS = {2: (0, 1), 4: (0, 2, 3)}   # [sp-kernel]: seq size -> the ranks checked
SP_UNCOVERED = 92240         # samples: 289 / 145 / 73 frames, no point divides by 2
SP_TIMEOUT = 420             # seconds for [sp-slice]'s ranks
CONTEXTNET = (80, 240, 5)    # [contextnet]: ContextNetSubsampling's mels, features and kernel
CONTEXTNET_TOL = 1e-4        # fp32 on the card vs the CPU, relative to max(|y|, 1)
WIDE_FP32_BATCH = 2          # [wide-fp32-kernel]: B at the wide stage shapes of 16 s
WIDE_FP32_CONFIGS = ("EfficientConformerCTCMedium", "EfficientConformerCTCLarge",
                     "ConformerCTCLarge", "EfficientConformerTransducerMedium")
WIDE_FP32_SECONDS = (16.0, 8.0)   # [wide-fp32-slice]: one step of 2 utterances
WIDE_BF16_CONFIGS = ("EfficientConformerCTCMedium", "EfficientConformerCTCLarge",
                     "EfficientConformerTransducerMedium")   # [wide-bf16-slice], as shipped
# [wider-kernel] and [wider-slice]: two encoders past the widths the shipped
# ones reach, each a shipped config with one field changed (name: config,
# the change, the depth kept); heads 270 / 128 / 180 (G 3 in stage 1), and 8
# heads of 128 at rel width 1,024 (the large Conformers of arXiv:2010.10504)
WIDER_MODELS = {
    "EfficientConformerCTCLarge_heads4": ("EfficientConformerCTCLarge", {"num_heads": 4}, None),
    "ConformerCTCLarge_width1024": ("ConformerCTCLarge", {"dim_model": 1024}, 6),
}
# (dh, D) at H 4, N 201 (B 2): the four shapes the wrapper refused before the
# wide routes, and dh 512 / D 1024
WIDER_FREE_SHAPES = ((257, 64), (272, 544), (150, 64), (64, 4000), (512, 1024))
# [widest-kernel]: the bias kernels past a width of 256, (dqk, dv); and
# [causal-wide-slice], the path that sends them 270: WIDER_MODELS' Large at 4
# heads made causal
WIDEST_WIDTHS = ((257, 257), (270, 270), (272, 272), (384, 384), (512, 512), (1024, 1024),
                 (270, 135), (64, 512), (512, 64))
WIDEST_STEP_KEYS = (100, 513, 1025)   # one query row (the LM's KV-cache step, B 1) and Nk
CAUSAL_WIDE_MODEL = "EfficientConformerCTCLarge_heads4"
CAUSAL_WIDE_STREAM_SECONDS = (12.0, 9.0)   # its two streamed utterances
BF16_GRAD_NOISE = 1.25       # a bf16 step's gradients through the kernels no farther from
                             # the fp32 step's (global relative L2) than 1.25x the plain
                             # versions' bf16 gradients are: through 15-16 bf16 blocks the
                             # gradients move 1.6-2.7% from fp32, and one parameter's up to
                             # ~10% of its largest (NVIDIA H100 80GB HBM3, 700 W: plain
                             # 0.0274 / 0.0205 / 0.0158, kernels 0.0268 / 0.0206 / 0.0154
                             # on EfficientConformer CTC Medium, Large, Transducer Medium)
BF16_LEAF_NOISE = 3.0        # and each parameter's gradient no farther from its fp32 one (L2)
                             # than 3x the plain versions' bf16 gradient of it is: clean
                             # steps read <= 2.22, one layer's zeroed column group of dqu, dk
                             # or dv, or head of dW or ddelta >= 5.12 (the same card)
BF16_LEAF_FLOOR = 1e-3       # that distance floored at 1e-3 of the parameter's fp32 gradient
BF16_LEAF_ZERO = 1e-4        # left out of it: gradients zero but for rounding, under 1e-4 of
                             # an RMS-sized one (a key projection's bias under the softmax, a
                             # conv's before a BatchNorm: <= 6.9e-6; the least other >= 1.7e-3)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


START = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One phase line, ending with the seconds since the script started."""
    fields["at"] = f"{time.perf_counter() - START:.1f}s"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed and timed with CUDA events. Unlike cuda_ms it leaves out
    the host's time per call (Python, allocations, the launch: 40-120 us for
    the bias-attention wrappers), which back-to-back eager calls expose once
    a kernel takes about as long."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(flops: float, nbytes: float, peak: float = BF16_PEAK) -> tuple[float, str]:
    """(ms, what bounds it): the larger of FLOPs over the peak of their type
    (bf16 tensor cores unless given) and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def attention_cost(b, n, dh, d, h, itemsize, backward, nk=None):
    """FLOPs of the products each direction must compute, 2 per
    multiply-add, and the bytes each input read once and each output
    written once: qu, k, v (+ o, dO) and the token outputs in the input
    type; LSE, delta, W, the tables and the key bias in fp32; dW and ddelta
    in fp32 for the backward. Forward, per (batch, head), N query rows and
    Nk keys (Nk = N unless given): A = rot((qu + delta) W) (N dh D), S =
    [qu | A] [k | keytab]^T (N Nk (dh + D)), P V (N Nk dh). Backward: S
    recomputed (N Nk (dh + D)), dP = dO V^T, dV = P^T dO, dk = dS^T qu and
    dS k (N Nk dh each), dA = dS keytab (N Nk D), and A recomputed, dpq W^T
    and dW = qv^T dpq (N dh D each)."""
    nk = n if nk is None else nk
    tok, tok_k = b * h * n * dh * itemsize, b * h * nk * dh * itemsize
    consts = (h * dh + h * dh * d + (n + nk) * d + b * nk) * 4 + b * h * n * 4
    if backward:
        flops = 2 * b * h * n * (nk * (5 * dh + 2 * d) + 3 * dh * d)
        return flops, 3 * tok + 2 * tok_k + consts + tok + 2 * tok_k + (h * dh * d + h * dh) * 4
    return 2 * b * h * n * (nk * (2 * dh + d) + dh * d), tok + 2 * tok_k + consts + tok


def augmented(args):
    """[qu | A], [k | keytab] (A formed with plain torch) and v, each
    zero-padded to a multiple of 8 columns, and the key mask in bf16: the
    inputs of the library yardstick. Zero columns change neither the scores
    nor the other columns of O; without them (widths 210, 300, 90, 42, 60)
    scaled_dot_product_attention falls back to its fp32 math path."""
    qu, k, v, delta, w, rowtab, keytab, bias, scale = args
    qv = qu.float() + delta[None, :, None, :]
    pq = torch.einsum("bhnd,hdk->bhnk", qv, w)
    hd = pq.shape[-1] // 2
    sin, cos = rowtab[:, :hd], rowtab[:, hd:]
    a = torch.cat([sin * pq[..., :hd] + cos * pq[..., hd:],
                   sin * pq[..., hd:] - cos * pq[..., :hd]], dim=-1)
    qa = torch.cat([qu, a.to(qu.dtype)], dim=-1)
    ka = torch.cat([k, keytab.to(k.dtype).expand(k.shape[0], k.shape[1], -1, -1)], dim=-1)
    return pad8(qa), pad8(ka), pad8(v), bias.to(qu.dtype)


def pad8(t):
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def sdpa_yardstick(qa, ka, v, mask, scale, do=None):
    """(fn, backend): scaled_dot_product_attention on the augmented features
    (forward, or forward and backward against ``do``) restricted to its
    memory-efficient kernel, the one that takes these widths and a float
    mask; where that refuses them, PyTorch's own choice ("default")."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        o = F.scaled_dot_product_attention(qa, ka, v, attn_mask=mask, scale=scale)
        return o if do is None else torch.autograd.grad(o, (qa, ka, v), do)

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return call()

    try:
        efficient()
        torch.cuda.synchronize()
    except RuntimeError:
        return call, "default"
    return efficient, "efficient"


# ---------------------------------------------------------------- inputs


def stage_shapes(enc_params: dict, seconds: float):
    """(name, N, dh, D, H, G) of the first attention layer of each stage at
    ``seconds`` of audio, as the encoder gives them."""
    from efficientconformer_torch.config import resolve_block_configs

    hop = enc_params["sample_rate"] * enc_params["hop_length_ms"] // 1000
    t = round(seconds * SAMPLE_RATE) // hop + 1
    for _ in range(enc_params["subsampling_layers"]):
        t = (t - 1) // 2 + 1
    shapes, seen = [], set()
    for blk in resolve_block_configs(enc_params):
        d, h, g = blk.dim_model, blk.num_heads, blk.att_group_size
        if (d, g) not in seen:
            seen.add((d, g))
            layout = "grouped" if g > 1 else "plain"
            shapes.append((f"D{d}_{layout}", -(-t // g), g * d // h, d, h, g))
        if blk.stride > 1:
            t = (t - 1) // blk.stride + 1
    return shapes


def attention_inputs(b, n, dh, d, h, g, device, gen, free_w=False):
    """qu, k, v (B, H, N, dh), delta, W, the tables, a ragged key mask and
    the scale. W folds a random pos kernel as the layer does (grouped where
    G > 1), or with ``free_w`` is random at (H, dh, D) at the scale such a
    kernel folds to (D^-1/2), for any head width."""
    from efficientconformer_torch.ops import rel_factorize as RF
    from efficientconformer_torch.ops.attention import NEG_INF

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    qu, k, v = randn(b, h, n, dh), randn(b, h, n, dh), randn(b, h, n, dh)
    if free_w:
        delta, w = randn(h, dh, scale=0.1), randn(h, dh, d, scale=d ** -0.5)
    else:
        pos_kernel = randn(d, d, scale=d ** -0.5)
        delta = randn(h, dh, scale=0.1)
        if g > 1:
            w = RF.rel_w_grouped(h, dh, pos_kernel, g, d // 2)
        else:
            w = RF.rel_w_plain(pos_kernel, h, d // 2)
    rowtab, keytab = RF.rel_tables(n, n, d, g, torch.device(device))
    lengths = torch.linspace(n // 2, n, b).long()
    mask = (torch.arange(n)[None, :] >= lengths[:, None]).float()[:, None, None, :]
    bias = (mask * NEG_INF).to(device)
    return qu, k, v, delta, w, rowtab, keytab, bias, 1.0 / math.sqrt(dh)


def rank_heads(args, heads):
    """``attention_inputs`` cut to a rank's first ``heads`` heads under
    tensor parallelism (qu, k, v, delta and the per-head W), as the
    attention module cuts them: the head width and the tables stay."""
    if heads is None:
        return args
    qu, k, v, delta, w = (t[:, :heads] if i < 3 else t[:heads]
                          for i, t in enumerate(args[:5]))
    return (qu.contiguous(), k.contiguous(), v.contiguous(), delta.contiguous(),
            w.contiguous(), *args[5:])


def ragged_audio(seconds, device, rng):
    n = [int(s * SAMPLE_RATE) for s in seconds]
    x = (rng.standard_normal((len(n), max(n))) * 0.1).astype(np.float32)
    for i, ni in enumerate(n):
        x[i, ni:] = 0.0
    return torch.from_numpy(x).to(device), torch.tensor(n, device=device)


def make_model(device, dtype):
    """The flagship at full width, weights from SEED, with non-trivial
    norm parameters and BatchNorm running statistics."""
    from efficientconformer_torch.models.model_ctc import build_model

    return perturb_norms_(build_model(CONFIG, device, dtype, torch.Generator().manual_seed(SEED)))


def make_transducer(device, dtype):
    """Transducer Small at full width, as make_model."""
    from efficientconformer_torch.models.transducer import build_model

    return perturb_norms_(build_model(T_CONFIG, device, dtype,
                                      torch.Generator().manual_seed(SEED)))


def perturb_norms_(model):
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
                shape = m.weight.shape
                m.weight.copy_(1.0 + 0.1 * torch.randn(shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(shape, generator=gen))
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.copy_(0.2 * torch.randn(shape, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(shape, generator=gen))
    return model


# ---------------------------------------------------------------- phases


def rel_counts():
    from efficientconformer_torch.ops import rel_attention as RA

    return (RA.relpos_attention.launches, RA.relpos_attention.tc_launches,
            RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches)


def reset_rel_counts():
    from efficientconformer_torch.ops import rel_attention as RA

    for fn in (RA.relpos_attention, RA.relpos_attention_bwd):
        fn.launches = fn.tc_launches = fn.wide_launches = 0


def wide_counts():
    """(forward, backward) launches on a wide route since the last reset."""
    from efficientconformer_torch.ops import rel_attention as RA

    return RA.relpos_attention.wide_launches, RA.relpos_attention_bwd.wide_launches


def check_forward(phase, enc_params, seconds, gen, batch=CHECK_BATCH, heads=None, cut=None):
    """The rel-pos forward kernel vs its plain version at the stage shapes
    of ``seconds`` of audio over ``batch`` rows (``heads`` of them, a rank's
    under tensor parallelism, when given; ``cut(name, args)`` the inputs
    cut to a rank's query rows under sequence parallelism): fp32 (the FMA
    kernel) and bf16 (the tensor-core kernel, by the route counters), each
    vs the fp32 plain version on the same inputs. The largest fp32 and bf16
    errors."""
    from efficientconformer_torch.ops import rel_attention as RA

    max_err = max_err16 = 0.0
    for name, n, dh, d, h, g in stage_shapes(enc_params, seconds):
        args = rank_heads(attention_inputs(batch, n, dh, d, h, g, "cuda", gen), heads)
        if cut is not None:
            args = cut(name, args)
        h = heads or h
        reset_rel_counts()
        o_k, lse_k = RA.relpos_attention(*args)
        o_p, lse_p = RA.reference_relpos_attention(*args)
        torch.cuda.synchronize()
        check(rel_counts()[:2] == (1, 0), f"{name} fp32: route counts {rel_counts()}")
        err_o = (o_k - o_p).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        check(err_o <= KERNEL_FP32_TOL and err_lse <= KERNEL_FP32_TOL,
              f"{name} fp32: |O| {err_o} |LSE| {err_lse} > {KERNEL_FP32_TOL}")
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o_b, _ = RA.relpos_attention(*args16)
        o_bp, _ = RA.reference_relpos_attention(*[t.float() for t in args16[:3]], *args[3:])
        torch.cuda.synchronize()
        check(rel_counts()[:2] == (2, 1), f"{name} bf16: route counts {rel_counts()}, "
              "expected the tensor-core kernel")
        err_b = (o_b.float() - o_bp).abs().max().item()
        check(o_b.dtype == torch.bfloat16 and err_b <= KERNEL_BF16_TOL,
              f"{name} bf16: |O| {err_b} > {KERNEL_BF16_TOL}")
        max_err, max_err16 = max(max_err, err_o, err_lse), max(max_err16, err_b)
        say(phase, shape=name, B=batch, N=n, Nq=args[0].shape[2], dh=dh, D=d, H=h, G=g,
            fp32_err_o=f"{err_o:.3g}", fp32_err_lse=f"{err_lse:.3g}", bf16_err_o=f"{err_b:.3g}",
            route="fma/tensor-core")
    return max_err, max_err16


def phase_kernel(enc_params):
    """The forward checked at the inference stage shapes, then timed at
    b128 in bf16: the kernel, its fp32 route and the library from CUDA
    graphs (device time; *_ms), the kernel also per eager call (host time
    included; kernel_call_ms), the plain version per eager call, and the
    bound. The library's backend stands in each line."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED)
    shapes = stage_shapes(enc_params, TIME_SECONDS)
    max_err, max_err16 = check_forward("kernel", enc_params, TIME_SECONDS, gen)
    times = {"kernel": 0.0, "kernel_call": 0.0, "plain": 0.0, "kernel_fp32": 0.0,
             "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TIME_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        library, backend = sdpa_yardstick(*augmented(args16), args[8])
        row = {"kernel": graph_ms(lambda: RA.relpos_attention_fwd(*args16)),
               "kernel_call": cuda_ms(lambda: RA.relpos_attention_fwd(*args16)),
               "plain": cuda_ms(lambda: RA.reference_relpos_attention(*args16)),
               "kernel_fp32": graph_ms(lambda: RA.relpos_attention_fwd(*args)),
               "library": graph_ms(library)}
        row["bound"], bound_by = bound(*attention_cost(TIME_BATCH, n, dh, d, h, 2, False))
        for label, value in row.items():
            times[label] += value
        say("kernel-time", shape=name, B=TIME_BATCH, bound_by=bound_by,
            library=f"sdpa_{backend}", **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
    return max_err, max_err16, times


def grad_errors(got, want):
    """max |diff| / max(max|want|, 1) of each of the six gradients."""
    names = ("dqu", "dk", "dv", "ddelta", "dw", "dbias")
    return {n: (g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1.0)
            for n, g, w in zip(names, got, want)}


def check_backward(phase, enc_params, seconds, gen, heads=None, cut=None):
    """The rel-pos backward kernels at the stage shapes of ``seconds`` of
    audio (``heads`` of them when given; ``cut`` as in check_forward): fp32
    (the FMA kernels) against the
    plain backward on the same o, LSE and dO; bf16 (the tensor-core kernels,
    by the route counters) against the plain backward on the same bf16
    inputs, twice, the second bitwise equal to the first. The largest fp32
    error and the largest bf16 relative error."""
    from efficientconformer_torch.ops import rel_attention as RA

    max_err = max_err16 = 0.0
    for name, n, dh, d, h, g in stage_shapes(enc_params, seconds):
        args = rank_heads(attention_inputs(CHECK_BATCH, n, dh, d, h, g, "cuda", gen), heads)
        if cut is not None:
            args = cut(name, args)
        h = heads or h
        o, lse = RA.reference_relpos_attention(*args)
        do = torch.randn(o.shape, generator=gen).cuda()
        reset_rel_counts()
        got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
        want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
        torch.cuda.synchronize()
        err = grad_errors(got, want)
        check(max(err.values()) <= GRAD_TOL, f"{name} fp32 backward: {err} > {GRAD_TOL}")
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o16, lse16 = RA.relpos_attention_fwd(*args16)
        got16 = RA.relpos_attention_bwd(*args16[:8], o16, do.bfloat16(), lse16, args[8])
        again = RA.relpos_attention_bwd(*args16[:8], o16, do.bfloat16(), lse16, args[8])
        want16 = RA.reference_relpos_attention_bwd(*args16[:8], do.bfloat16(), lse16, args[8])
        torch.cuda.synchronize()
        check(rel_counts()[2:] == (3, 2), f"{name}: backward route counts {rel_counts()[2:]}, "
              "expected fp32 on the FMA kernels and bf16 on the tensor cores")
        check(all(torch.equal(a, b) for a, b in zip(got16, again)),
              f"{name} bf16 backward is not bitwise repeatable")
        err16 = grad_errors(got16, want16)
        check(got16[0].dtype == torch.bfloat16 and max(err16.values()) <= GRAD_BF16_TOL,
              f"{name} bf16 backward: {err16} > {GRAD_BF16_TOL}")
        max_err = max(max_err, *[(a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want)])
        max_err16 = max(max_err16, *err16.values())
        say(phase, shape=name, B=CHECK_BATCH, N=n, Nq=args[0].shape[2], dh=dh, D=d, H=h, G=g,
            fp32_rel_err=f"{max(err.values()):.3g}", bf16_rel_err=f"{max(err16.values()):.3g}",
            bf16_repeatable="bitwise")
    return max_err, max_err16


def phase_kernel_bwd(enc_params):
    """The backward kernels checked at the training stage shapes, then timed
    at batch 32, bf16, as phase_kernel times the forward; the library
    yardstick is the forward and backward of scaled_dot_product_attention
    on the augmented features."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED + 2)
    shapes = stage_shapes(enc_params, TRAIN_SECONDS)
    max_err, max_err16 = check_backward("kernel-bwd", enc_params, TRAIN_SECONDS, gen)
    times = {"kernel": 0.0, "kernel_call": 0.0, "plain": 0.0, "kernel_fp32": 0.0,
             "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TRAIN_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o, lse = RA.relpos_attention_fwd(*args16)
        o32, lse32 = RA.relpos_attention_fwd(*args)
        do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
        do32 = do.float()
        qa, ka, v, mask = augmented(args16)
        qa, ka, v = (t.detach().requires_grad_() for t in (qa, ka, v))
        library, backend = sdpa_yardstick(qa, ka, v, mask, args[8], pad8(do))

        def kernel():
            return RA.relpos_attention_bwd(*args16[:8], o, do, lse, args[8], need_dbias=False)

        row = {"kernel": graph_ms(kernel), "kernel_call": cuda_ms(kernel),
               "plain": cuda_ms(lambda: RA.reference_relpos_attention_bwd(
                   *args16[:8], do, lse, args[8])),
               "kernel_fp32": graph_ms(lambda: RA.relpos_attention_bwd(
                   *args[:8], o32, do32, lse32, args[8], need_dbias=False)),
               "library": graph_ms(library)}
        row["bound"], bound_by = bound(*attention_cost(TRAIN_BATCH, n, dh, d, h, 2, True))
        for label, value in row.items():
            times[label] += value
        say("kernel-bwd-time", shape=name, B=TRAIN_BATCH, N=n, bound_by=bound_by,
            library=f"sdpa_{backend}", **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
    return max_err, max_err16, times


def phase_requests():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.models.model_ctc import greedy_decode

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.bfloat16)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    reset_rel_counts()
    tokens, counts = greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    n_att = len(model.encoder.blocks)
    check(launches == n_att and tc == n_att, f"{launches} kernel launches for one forward, "
          f"{tc} on the tensor cores, expected {n_att} each")
    frames = [encoder_output_frames(enc_params, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    counts = counts.tolist()
    check(all(0 <= c <= f for c, f in zip(counts, frames)), f"token counts {counts} vs {frames}")
    check(tokens.shape == (len(REQUEST_SECONDS), max(frames)), f"tokens {tuple(tokens.shape)}")
    say("requests", seconds=list(REQUEST_SECONDS), frames=frames, tokens=counts,
        launches=launches, tc_launches=tc)
    return launches, tc


def phase_slice():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.ops import rel_attention as RA

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.float32)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    reset_rel_counts()
    with torch.inference_mode():
        logits_k, len_k = model(x, x_len)
        torch.cuda.synchronize()
        counts = rel_counts()[:2]
        check(counts == (len(model.encoder.blocks), 0), f"fp32 launches {counts}, expected "
              "every one on the FMA route")
        with mock.patch.object(RA, "relpos_attention", RA.reference_relpos_attention):
            logits_p, len_p = model(x, x_len)
    frames = [encoder_output_frames(enc_params, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    check(len_k.tolist() == frames and len_p.tolist() == frames, f"lengths {len_k.tolist()}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    valid = torch.arange(logits_k.shape[1], device="cuda")[None, :] < len_k[:, None]
    err = (logits_k - logits_p).abs()[valid].max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[valid].float().mean().item()
    check(err <= SLICE_TOL, f"kernel vs plain logits |diff| {err} > {SLICE_TOL}")
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"argmax agreement {agree}")

    # the same model and batch on the CPU, where attention is the plain version
    cpu_model = make_model("cpu", torch.float32)
    with torch.inference_mode():
        logits_c, _ = cpu_model(x.cpu(), x_len.cpu())
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU logits |diff| {err_cpu} > {SLICE_TOL}")
    say("slice", dtype="float32", max_abs_diff=f"{err:.3g}", argmax_agreement=f"{agree:.6f}",
        cpu_max_abs_diff=f"{err_cpu:.3g}", frames=frames, launches=counts[0], route="fma")


def phase_rate(card_line: str):
    from efficientconformer_torch.models.model_ctc import greedy_decode

    model = make_model("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((TIME_BATCH, n)) * 0.1).astype(np.float32)).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    greedy_decode(model, x, x_len)
    reset_rel_counts()
    greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    check(launches == tc == len(model.encoder.blocks),
          f"rel-pos launches {launches}, {tc} on the tensor cores, for one batch")
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, counts = greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(bool((counts >= 0).all()), "negative token counts")
    say("rate", batch=TIME_BATCH, seconds=TIME_SECONDS, dtype="bfloat16",
        ms_per_batch=f"{dt * 1e3:.2f}", audio_s_per_s=f"{TIME_BATCH * TIME_SECONDS / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=launches,
        tc_launches=tc, card=f"'{card_line}'")


# ---------------------------------------------------------------- training


def train_config(path=CONFIG, **training) -> dict:
    """The config at ``path``, its training_params updated by ``training``."""
    from efficientconformer_torch.config import load_config

    cfg = load_config(path)
    cfg["training_params"].update(training)
    return cfg


def one_block_a_stage(enc: dict) -> dict:
    """``enc`` cut to one block a stage, its published widths, heads, groups
    and kernels kept: the stride and the expansion after blocks 0, 1, ...
    (as the CPU tests cut the Medium and Large encoders); one block for a
    single-stage encoder."""
    cut = dict(enc, num_blocks=len(enc.get("strided_blocks") or []) + 1)
    for key in ("strided_blocks", "expand_blocks"):
        if enc.get(key):
            cut[key] = list(range(len(enc[key])))
    return cut


def train_batch(accum, batch, seconds, label_len, device, rng):
    """Stacked microbatches (accum, batch, ...): random waveforms of the
    given lengths (zero past them) and random labels in [1, V), on
    ``device``; the lengths stay on the host, where the trainer reads them."""
    secs = np.broadcast_to(np.asarray(seconds, dtype=np.float64), (accum, batch))
    n = (secs * SAMPLE_RATE).astype(np.int64)
    t = int(n.max())
    audio = (rng.standard_normal((accum, batch, t)) * 0.1).astype(np.float32)
    audio[np.arange(t)[None, None, :] >= n[..., None]] = 0.0
    labels = rng.integers(1, 256, (accum, batch, int(np.max(label_len))))
    y_len = np.broadcast_to(np.asarray(label_len), (accum, batch)).copy()
    labels[np.arange(labels.shape[-1])[None, None, :] >= y_len[..., None]] = 0
    return {"audio": torch.from_numpy(audio).to(device), "audio_len": torch.from_numpy(n),
            "labels": torch.from_numpy(labels).to(device), "label_len": torch.from_numpy(y_len)}


def plain_relpos_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale,
                     need_dbias=True):
    from efficientconformer_torch.ops import rel_attention as RA

    return RA.reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do,
                                             lse, scale)


def plain_rnnt_alphas(blank_lp, emit_lp, f_len, y_len):
    from efficientconformer_torch.ops import rnnt_loss as RL

    alphas = RL.reference_rnnt_alphas(blank_lp, emit_lp)
    return alphas, RL.loss_from_alphas(alphas, blank_lp, f_len, y_len)


def plain_bias_bwd(q, k, v, bias, o, do, lse, scale, need_dbias=True):
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.reference_bias_attention_bwd(q, k, v, bias, do, scale)


@contextlib.contextmanager
def plain_kernels():
    """Both directions of the rel-pos attention, of the RNN-T lattice and of
    the bias attention through their plain versions, on whatever device the
    tensors lie."""
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    with mock.patch.object(RA, "relpos_attention_fwd", RA.reference_relpos_attention), \
            mock.patch.object(RA, "relpos_attention_bwd", plain_relpos_bwd), \
            mock.patch.object(RL, "rnnt_alphas", plain_rnnt_alphas), \
            mock.patch.object(RL, "rnnt_grads", RL.reference_rnnt_grads), \
            mock.patch.object(BA, "bias_attention_fwd", BA.reference_bias_attention), \
            mock.patch.object(BA, "bias_attention_bwd", plain_bias_bwd):
        yield


def one_step(cfg, device, batch, plain=False):
    """(loss, grad norm, gradients, BatchNorm statistics) of one train step
    from the seeded weights; the gradients and statistics on the CPU."""
    from efficientconformer_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device, seed=SEED)
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, grad_norm = trainer.train_step(batch)
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers() if "running" in n}
    return float(loss), float(grad_norm), grads, stats


def rel_diff(got: dict, want: dict) -> float:
    return max(((got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1.0)
                for k in want), default=0.0)


def compare_steps(kernel, cfg, batch) -> dict:
    """Hold one step through the kernels (``kernel``, from one_step) to the
    same step through the plain versions on the card and on the CPU: loss,
    gradient norm, gradients, BatchNorm statistics. The errors, by name."""
    out = {}
    for label, other in (("plain", one_step(cfg, "cuda", batch, plain=True)),
                         ("cpu", one_step(cfg, "cpu", batch))):
        loss_err = abs(kernel[0] - other[0]) / abs(other[0])
        norm_err = abs(kernel[1] - other[1]) / abs(other[1])
        grad_err, stats_err = rel_diff(kernel[2], other[2]), rel_diff(kernel[3], other[3])
        check(loss_err <= TRAIN_LOSS_RTOL and norm_err <= TRAIN_LOSS_RTOL,
              f"kernel vs {label}: loss {kernel[0]} / {other[0]}, norm {kernel[1]} / {other[1]}")
        check(grad_err <= TRAIN_GRAD_TOL, f"kernel vs {label}: gradients {grad_err}")
        check(stats_err <= TRAIN_STATS_TOL, f"kernel vs {label}: BatchNorm statistics {stats_err}")
        out.update({f"{label}_loss_rel": f"{loss_err:.3g}", f"{label}_norm_rel": f"{norm_err:.3g}",
                    f"{label}_grad_rel": f"{grad_err:.3g}", f"{label}_stats_rel": f"{stats_err:.3g}"})
    return out


def phase_train_slice():
    cfg = train_config(mixed_precision=False)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED))
    reset_rel_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    fwd, fwd_tc, bwd, bwd_tc = rel_counts()
    n_att = cfg["encoder_params"]["num_blocks"] * 2      # one attention layer per block
    check(fwd == n_att and bwd == n_att, f"{fwd} forward / {bwd} backward launches, "
          f"expected {n_att} each for 2 microbatches")
    check(fwd_tc == bwd_tc == 0, f"fp32 step: tensor-core launches {fwd_tc} / {bwd_tc}")
    out = compare_steps(kernel, cfg, batch)
    say("train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        fwd_launches=fwd, bwd_launches=bwd, route="fma", **out)


def phase_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(lr_schedule="Constant", lr_value=1e-3)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(1, 8, 4.0, [10, 14, 18, 12, 16, 8, 20, 11], "cuda",
                        np.random.default_rng(SEED + 3))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("train-learns", steps=LEARN_STEPS, batch="8x4s", first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", min_loss=f"{min(losses):.4f}")


def rate_trainer():
    """The config's own training step (bf16, dropout 0.1, SpecAugment, Adam +
    Transformer schedule) and its batch: 2 microbatches of 32 x 16 s with
    labels of 80 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config()
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(tp["accumulated_steps"], tp["batch_size"],
                        tp["train_audio_max_length"] / SAMPLE_RATE, [80], "cuda",
                        np.random.default_rng(SEED + 4))
    return trainer, batch


def phase_train_rate(card_line: str):
    trainer, batch = rate_trainer()
    accum, b, t = batch["audio"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_rel_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    fwd, fwd_tc, bwd, bwd_tc = rel_counts()
    n_att = trainer.config["encoder_params"]["num_blocks"] * accum
    check(fwd == n_att and bwd == n_att,
          f"{fwd} forward / {bwd} backward launches in one step, expected {n_att} each")
    check(fwd_tc == fwd and bwd_tc == bwd, f"tensor-core launches {fwd_tc} / {bwd_tc}, "
          "expected every launch")
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    audio_s = accum * b * t / SAMPLE_RATE
    say("train-rate", microbatches=accum, batch=b, seconds=t / SAMPLE_RATE, dtype="bfloat16",
        ms_per_step=f"{dt * 1e3:.2f}", audio_s_per_s=f"{audio_s / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}",
        fwd_launches=fwd, bwd_launches=bwd, tc_launches=(fwd_tc, bwd_tc), card=f"'{card_line}'")
    return bwd, bwd_tc, dt * 1e3


# ---------------------------------------------------------------- data parallelism


def dp_adam(cfg) -> tuple:
    """A non-zero Adam state for ``cfg``'s model by parameter name, seeded,
    after 10 updates: from a zero state every update is lr * g / |g|, and
    the rounding noise of gradients that are 0 in exact arithmetic would
    move their weights by +-lr."""
    from efficientconformer_torch.models import factory

    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 91)
    shapes = [(n, p.shape) for n, p in model.named_parameters()]
    mu = {n: (rng.standard_normal(s) * 1e-3).astype(np.float32) for n, s in shapes}
    nu = {n: rng.uniform(1e-4, 1e-3, s).astype(np.float32) for n, s in shapes}
    return mu, nu, 10


# a case's "adam" drawn in the rank by ``dp_adam``: the moments of a full-width
# model are hundreds of MB, which spawning the ranks would pickle to each
ADAM_IN_RANK = "dp_adam"


def in_rank(case: dict) -> dict:
    """``case`` with its Adam state drawn again in the rank (``one_process``)."""
    return dict(case, adam=ADAM_IN_RANK)


def dp_cases(ranks=DP_RANKS) -> list:
    """[dp-slice]'s steps: 2 rows a rank of 2 microbatches of ragged
    utterances of 4-8 s, the flagship at full width and depth (cut to one
    block a stage, its fp32 norm lies 1.4e-5 from one process's, past its
    gate), fp32 then bf16."""
    seconds = np.resize([4.0, 5.5, 7.0, 8.0, 8.0, 6.5, 4.5, 5.0], (2, 2 * ranks))
    batch = {k: v.numpy() for k, v in train_batch(2, 2 * ranks, seconds,
                                                  np.resize([12, 30, 0, 20], 2 * ranks), "cpu",
                                                  np.random.default_rng(SEED + 90)).items()}
    cases = []
    for mixed in (False, True):
        cfg = train_config(mixed_precision=mixed, lr_schedule="Constant", lr_value=1e-3)
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        cases.append({"config": cfg, "batch": batch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False})
    return cases


def phase_dp_slice(card_line, ranks=DP_RANKS, backend="gloo", phase="dp-slice", cases=None,
                   launched=None):
    """Data parallelism at full width: ``ranks`` ranks, by default two on
    the one card over gloo (NCCL refuses two ranks on one device), each
    stepping on its 2 rows of 2 microbatches of ragged utterances of 4-8 s
    ([train-slice]'s at two ranks) under DDP and the globally synced
    BatchNorm (dropout 0, SpecAugment off, Adam from a shared non-zero state
    at a constant 1e-3), fp32 then bf16; each held to the one-process step
    over the global batch on the (first) card: loss and gradient norm, the
    updated parameters and BatchNorm's running statistics, the parameters
    and statistics bit for bit equal across the ranks. ``backend`` None:
    NCCL, one rank a GPU. ``cases`` (``dp_cases``') may have run already in
    another phase's launch of the same ranks: ``launched`` is then (each
    rank's results, that launch's seconds). Returns the rel-pos (forward,
    backward) launches summed over the ranks and both steps."""
    from efficientconformer_torch import dryrun
    from efficientconformer_torch.parallel import mesh

    cases = dp_cases(ranks) if cases is None else cases
    shared = launched is not None
    if launched is None:
        t0 = time.perf_counter()
        outs = mesh.launch(rank_steps, ranks, ([in_rank(c) for c in cases],),
                           device_type="cuda", backend=backend, timeout=DP_TIMEOUT)
        launched = outs, time.perf_counter() - t0
    outs, ranks_s = launched
    backend = backend or mesh.default_backend("cuda")
    n_att = cases[0]["config"]["encoder_params"]["num_blocks"] * 2   # 2 microbatches
    total = [0, 0]
    for i, case in enumerate(cases):
        fp32 = not case["config"]["training_params"]["mixed_precision"]
        one = dryrun.shard_step(**case, device="cuda")
        got = [r[i] for r in outs]
        loss_err = max(abs(g["loss"] - one["loss"]) / abs(one["loss"]) for g in got)
        norm_err = max(abs(g["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
                       for g in got)
        stats = [{k: v for k, v in g["buffers"].items() if "running" in k} for g in got + [one]]
        param_err = max(rel_diff(g["params"], one["params"]) for g in got)
        stats_err = max(rel_diff(st, stats[-1]) for st in stats[:-1])
        tol, loss_tol = (DP_FP32_TOL, DP_LOSS_RTOL) if fp32 else (DP_BF16_TOL, DP_BF16_TOL)
        label = f"[{phase}] {'fp32' if fp32 else 'bf16'}"
        check(loss_err <= loss_tol and norm_err <= loss_tol,
              f"{label}: loss {[g['loss'] for g in got]} / {one['loss']}, "
              f"norm {[g['grad_norm'] for g in got]} / {one['grad_norm']}")
        check(param_err <= tol and stats_err <= tol,
              f"{label}: parameters {param_err}, statistics {stats_err}")
        check(all(torch.equal(st[k], stats[0][k]) for st in stats[1:-1] for k in stats[0]),
              f"{label}: the ranks' running statistics differ")
        check(all(torch.equal(g["params"][k], got[0]["params"][k]) for g in got[1:]
                  for k in one["params"]), f"{label}: the ranks' parameters differ")
        per_rank = []
        for g in got:
            c = g["launches"]
            per_rank.append((c["relpos_fwd"], c["relpos_bwd"]))
            tc = (c["relpos_fwd_tc"], c["relpos_bwd_tc"])
            check(per_rank[-1] == (n_att, n_att) and tc == ((0, 0) if fp32 else (n_att, n_att)),
                  f"{label} rank {g['rank']}: rel-pos launches {c}, expected "
                  f"{n_att} / {n_att} on the {'FMA' if fp32 else 'tensor-core'} route")
            check(g["ddp"] and g["world"] == ranks and g["ddp_all_reduces"] > 0
                  and g["bn_all_reduces"] > 0,
                  f"{label} rank {g['rank']}: DDP {g['ddp']}, world {g['world']}, "
                  f"all-reduces {g['ddp_all_reduces']} / {g['bn_all_reduces']}")
            total = [total[0] + c["relpos_fwd"], total[1] + c["relpos_bwd"]]
        say(phase, dtype="float32" if fp32 else "bfloat16", ranks=ranks, backend=backend,
            rows_per_rank=2, microbatches=2, loss=f"{got[0]['loss']:.6f}",
            loss_rel=f"{loss_err:.3g}", norm_rel=f"{norm_err:.3g}",
            param_rel=f"{param_err:.3g}", stats_rel=f"{stats_err:.3g}", tol=tol,
            equal_across_ranks=True, relpos_launches_per_rank=per_rank,
            route="fma" if fp32 else "tensor-core",
            ddp_all_reduces=got[0]["ddp_all_reduces"], bn_all_reduces=got[0]["bn_all_reduces"],
            ranks_seconds=f"{ranks_s:.2f}", shared_launch=shared, card=f"'{card_line}'")
    return tuple(total)


def phase_dp_rate(card_line, train_rate_ms):
    """One rank over NCCL through DDP on the flagship's own bf16 step
    ([train-rate]'s 2 x 32 x 16 s, dropout 0.1, SpecAugment): its first
    step's parameters and buffers bit for bit those of the step without DDP
    from the same seed (and whether that step repeats itself bit for bit),
    its rel-pos launches, then ms a step with and without DDP in turns
    (plain, DDP, DDP, plain): DDP's own overhead on this card. Returns the
    rel-pos (forward, backward) launches of one DDP step."""
    import torch.distributed as dist

    from efficientconformer_torch.parallel import mesh
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config()
    tp = cfg["training_params"]
    batch = train_batch(tp["accumulated_steps"], tp["batch_size"],
                        tp["train_audio_max_length"] / SAMPLE_RATE, [80], "cuda",
                        np.random.default_rng(SEED + 4))
    with mesh.process_group(0, 1, "cuda"):
        backend = dist.get_backend()
        trainers = {"ddp": Trainer(cfg, device="cuda", seed=SEED, ddp=True),
                    "plain": Trainer(cfg, device="cuda", seed=SEED, ddp=False),
                    "again": Trainer(cfg, device="cuda", seed=SEED, ddp=False)}
        for t in trainers.values():
            t.train_step(batch)
        torch.cuda.synchronize()
        state = {k: {**{n: p.detach() for n, p in t.model.named_parameters()},
                     **dict(t.model.named_buffers())} for k, t in trainers.items()}
        same = all(torch.equal(state["ddp"][n], v) for n, v in state["plain"].items())
        repeat = all(torch.equal(state["again"][n], v) for n, v in state["plain"].items())
        del trainers["again"], state
        check(backend == "nccl" and trainers["ddp"].ddp is not None, f"[dp-rate] {backend}")
        check(same, f"[dp-rate] the DDP step's parameters differ from the step without DDP "
              f"(the step without DDP repeats itself bit for bit: {repeat})")
        reset_rel_counts()
        trainers["ddp"].train_step(batch)
        torch.cuda.synchronize()
        fwd, fwd_tc, bwd, bwd_tc = rel_counts()
        n_att = cfg["encoder_params"]["num_blocks"] * tp["accumulated_steps"]
        check((fwd, bwd) == (n_att, n_att) and (fwd_tc, bwd_tc) == (fwd, bwd),
              f"[dp-rate] rel-pos launches {fwd} / {bwd}, tensor cores {fwd_tc} / {bwd_tc}")
        ms = {"plain": [], "ddp": []}
        iters = 3
        for name in ("plain", "ddp", "ddp", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                loss, _ = trainers[name].train_step(batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / iters)
            check(math.isfinite(float(loss)), f"[dp-rate] {name}: loss {float(loss)}")
        del trainers
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "[dp-rate] the process group outlived the phase")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    say("dp-rate", ranks=1, backend=backend, microbatches=tp["accumulated_steps"],
        batch=tp["batch_size"], seconds=batch["audio"].shape[-1] / SAMPLE_RATE,
        dtype="bfloat16",
        ms_per_step_ddp=f"{mean['ddp']:.2f}", ms_per_step_plain=f"{mean['plain']:.2f}",
        ddp_overhead_ms=f"{mean['ddp'] - mean['plain']:.2f}",
        runs_ms={k: [f"{x:.2f}" for x in v] for k, v in ms.items()},
        train_rate_ms_per_step=f"{train_rate_ms:.2f}", params_bitwise_equal=same,
        plain_repeats_bitwise=repeat, rel_fwd_launches=fwd, rel_bwd_launches=bwd,
        tc_launches=(fwd_tc, bwd_tc), card=f"'{card_line}'")
    return fwd, bwd


# ---------------------------------------------------------------- tensor parallelism


def phase_tp_kernel():
    """[tp-kernel]: the kernels at a rank's head counts under tensor
    parallelism, against their plain versions, as [kernel], [kernel-bwd] and
    [lm-kernel] check them: the rel-pos forward and backward at the
    flagship's three 16 s stage shapes on 2 and 1 heads (model 2 and 4), the
    bias forward and backward at the LM's causal shape on 6 and 3 heads;
    fp32 on the FMA route and bf16 on the tensor cores, by the route
    counters; the shared memory each route takes at each stage shape (the
    head count does not enter it). Returns the largest errors: rel-pos
    forward (fp32, bf16), backward (fp32, bf16), bias forward, backward."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import rel_attention as RA

    enc_params = load_config(CONFIG)["encoder_params"]
    gen = torch.Generator().manual_seed(SEED + 93)
    fwd, bwd = [0.0, 0.0], [0.0, 0.0]
    for heads in TP_HEADS:
        e = check_forward("tp-kernel", enc_params, TRAIN_SECONDS, gen, heads=heads)
        fwd = [max(a, b) for a, b in zip(fwd, e)]
        e = check_backward("tp-kernel-bwd", enc_params, TRAIN_SECONDS, gen, heads=heads)
        bwd = [max(a, b) for a, b in zip(bwd, e)]
    for name, n, dh, d, h, g in stage_shapes(enc_params, TRAIN_SECONDS):
        say("tp-kernel-smem", shape=name, dh=dh, rel_width=d, heads_per_rank=TP_HEADS,
            tc_fwd_bwd_bytes=RA.smem_bytes(torch.bfloat16, dh, d),
            fma_fwd_bwd_bytes=RA.smem_bytes(torch.float32, dh, d), limit=RA.SMEM_LIMIT)
    p = lm_params()
    dh = p["dim_model"] // p["num_heads"]
    err_bf = err_bb = 0.0
    for heads in TP_LM_HEADS:
        args = bias_inputs(LM_CHECK_BATCH, heads, 101, 101, dh, dh, "causal", gen)
        ef, eb = check_bias_case(f"lm-causal-{heads}-heads", args, gen, phase="tp-kernel")
        err_bf, err_bb = max(err_bf, ef), max(err_bb, eb)
    return fwd, bwd, err_bf, err_bb


def tp_rows(ranks, model_parallel, rng) -> dict:
    """2 microbatches of 4 ragged rows of 4-8 s at one data rank (2 a data
    rank from two on), on the host."""
    data = ranks // model_parallel
    rows = max(4 // data, 2) * data
    seconds = np.resize([4.0, 5.5, 7.0, 8.0, 8.0, 6.5, 4.5, 5.0], (2, rows))
    return {k: v.numpy() for k, v in train_batch(2, rows, seconds,
                                                 np.resize([12, 30, 0, 20], rows), "cpu",
                                                 rng).items()}


def tp_cases(ranks, model_parallel, lm=True, transducer=True, cut=False) -> list:
    """[tp-slice]'s steps: the flagship's fp32 and bf16 steps ([dp-slice]'s
    settings: dropout 0, SpecAugment off, Adam from a shared non-zero state
    at a constant 1e-3), Transducer Small's fp32 step and the
    LM-Transformer's fp32 step, over 2 microbatches of 4 ragged rows at one
    data rank (2 a data rank from two on), at full width. With ``cut``
    every step but the flagship's fp32 step with its loss in fp32 at one
    block a stage (the LM at one block): cut too, that step's norm lies
    2.8e-5 from one process's, past its gate)."""
    rng = np.random.default_rng(SEED + 94)
    batch = tp_rows(ranks, model_parallel, rng)
    rows = batch["audio"].shape[1]
    cases = []
    # the flagship fp32, bf16, and fp32 with its loss in float64
    # (``float64_loss``); Transducer Small fp32, and with its loss in float64
    for path, mixed, f64, whole in ((CONFIG, False, False, True), (CONFIG, True, False, False),
                                    (CONFIG, False, True, False), (T_CONFIG, False, False, False),
                                    (T_CONFIG, False, True, False)):
        if path == T_CONFIG and not transducer:
            continue
        cfg = train_config(path, mixed_precision=mixed, lr_schedule="Constant", lr_value=1e-3)
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        if cut and not whole:
            cfg["encoder_params"] = one_block_a_stage(cfg["encoder_params"])
        cases.append({"config": cfg, "batch": batch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False, **({"float64_loss": True} if f64 else {})})
    if lm:
        cfg = train_config(LM_CONFIG, mixed_precision=False, lr_schedule="Constant",
                           lr_value=1e-3)
        cfg["lm_params"]["Pdrop"] = 0.0
        if cut:
            cfg["lm_params"]["num_blocks"] = 1
        lengths = np.resize([20, 55, 100, 10, 70, 35, 90, 45], (2, rows))
        lbatch = {k: v.numpy() for k, v in lm_batch(2, rows, lengths, "cpu", rng).items()}
        cases.append({"config": cfg, "batch": lbatch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False})
    return cases


@contextlib.contextmanager
def vocabulary_product(product):
    """A whole model's vocabulary projection (the CTC model's ``fc``, the
    joint's ``linear_joint``) computed by ``product(x, w, b)`` and rounded
    once to the activations' type."""
    from efficientconformer_torch.models.joint_networks import JointNetwork
    from efficientconformer_torch.models.model_ctc import ModelCTC

    def forward(self, x, x_len, generator=None):
        enc, enc_len, probs = self.encoder.forward_taps(x, x_len, generator)
        logits = product(enc, self.fc.weight, self.fc.bias).to(enc.dtype)
        return (logits, enc_len, probs) if self.interctc else (logits, enc_len)

    def logits(self, z):
        lin = self.linear_joint
        return product(z, lin.weight.to(z.dtype), lin.bias.to(z.dtype)).to(z.dtype)

    with mock.patch.object(ModelCTC, "forward", forward), \
            mock.patch.object(JointNetwork, "_logits", logits):
        yield


def float64_head():
    """The vocabulary projection computed in float64 and rounded once: the
    same logits up to the rounding of the fp32 product's sums, as splitting
    the product over ranks changes that rounding."""
    return vocabulary_product(lambda x, w, b: F.linear(x.double(), w.double(), b.double()))


def rnnt_loss_float64(logits, labels, f_len, y_len):
    """The RNN-T loss (B,) of the joint logits (B, T, U+1, V) in float64,
    differentiated by autograd: the alpha recursion of ops/rnnt_loss.py's
    plain version one anti-diagonal at a time, each a new tensor (no kernel:
    a diagnostic of the fp32 lattice's rounding)."""
    x = logits.double()
    b, t_max, u1, _ = x.shape
    dev = x.device
    f_len, y_len = f_len.to(dev).long(), y_len.to(dev).long()
    inside = torch.arange(labels.shape[1], device=dev)[None] < y_len[:, None]
    lab = F.pad(torch.where(inside, labels.to(dev), 0).long(), (0, 1))
    lse = torch.logsumexp(x, dim=-1)
    blank = x[..., 0] - lse
    emit = x.gather(3, lab[:, None, :, None].expand(-1, t_max, -1, 1))[..., 0] - lse
    u = torch.arange(u1, device=dev)
    neg = torch.full((b, u1), -1e30, dtype=torch.float64, device=dev)
    diags = [torch.where(u[None] == 0, torch.zeros_like(neg), neg)]      # cell (0, 0)
    for d in range(1, t_max + u1 - 1):
        t = d - u
        here = (t >= 0) & (t < t_max)
        stay = torch.where((t >= 1) & (t <= t_max), diags[-1]
                           + blank[:, (t - 1).clamp(0, t_max - 1), u], neg)
        left = torch.cat([neg[:, :1], diags[-1][:, :-1]], dim=1)        # cell (t, u - 1)
        move = torch.where(here & (u >= 1), left
                           + emit[:, t.clamp(0, t_max - 1), (u - 1).clamp(min=0)], neg)
        diags.append(torch.where(here, torch.logaddexp(stay, move), neg))
    rows = torch.arange(b, device=dev)
    last = torch.stack(diags)[f_len - 1 + y_len, rows, y_len]
    return -(last + blank[rows, f_len - 1, y_len])


@contextlib.contextmanager
def float64_loss():
    """The CTC and RNN-T losses (log-softmax and lattice) computed in
    float64 from the fp32 logits: without the fp32 lattices' rounding (their
    posteriors exp(alpha + beta - L), L a few hundred nats, carry an fp32
    error of ~3e-5), which moves the gradient at every change of the
    forward's rounding."""
    from efficientconformer_torch.models import factory
    from efficientconformer_torch.ops.ctc_loss import ctc_loss

    def ctc_fn(outputs, batch):
        logits, f_len = outputs
        lp = F.log_softmax(logits.double(), dim=-1)
        return ctc_loss(lp, batch["labels"], f_len, batch["label_len"]).mean().float()

    def rnnt_fn(outputs, batch):
        logits, f_len = outputs
        return rnnt_loss_float64(logits, batch["labels"], f_len,
                                 batch["label_len"]).mean().float()

    ctc_fn.host_labels = True
    with mock.patch.object(factory, "ctc_loss_fn", ctc_fn), \
            mock.patch.object(factory, "transducer_loss_fn", rnnt_fn):
        yield


def rank_steps(cases):
    """In a rank: ``one_process`` of each case in turn, with the bias
    kernels' launches by route of its step (``routes``)."""
    from efficientconformer_torch.ops import bias_attention as BA

    out = []
    for case in cases:
        BA.bias_attention.routes.clear()
        BA.bias_attention_bwd.routes.clear()
        o = one_process(case, None)
        o["routes"] = (dict(BA.bias_attention.routes), dict(BA.bias_attention_bwd.routes))
        out.append(o)
    return out


def one_process(case, device="cuda"):
    """``dryrun.shard_step`` of a case (on ``device``, None: the rank's),
    under ``float64_loss`` where it sets "float64_loss", its Adam state
    drawn here where it is ``ADAM_IN_RANK``."""
    from efficientconformer_torch import dryrun

    case = dict(case)
    f64 = case.pop("float64_loss", False)
    if case["adam"] == ADAM_IN_RANK:
        case["adam"] = dp_adam(case["config"])
    with float64_loss() if f64 else contextlib.nullcontext():
        return dryrun.shard_step(**case, device=device)


def split_head(n):
    """The vocabulary projection in tensor parallelism's layout: ``n`` column
    GEMMs of V/n rows each, concatenated (ROADMAP Queue 3's check of the
    fp32 norm gate)."""
    return vocabulary_product(lambda x, w, b: torch.cat(
        [F.linear(x, wi, bi) for wi, bi in zip(w.chunk(n), b.chunk(n))], dim=-1))


def phase_tp_slice(card_line, ranks=TP_RANKS, model_parallel=2, backend="gloo",
                   phase="tp-slice", lm=True, cases=None, cut=False, extra=()):
    """Tensor parallelism at full width: ``ranks`` ranks in model groups of
    ``model_parallel`` (by default two on the one card over gloo, data 1 x
    model 2; ``backend`` None: NCCL, one rank a GPU), each case of
    ``tp_cases`` against the one-process step over the global batch on the
    (first) card at [dp-slice]'s gates (fp32 loss and norm 1e-5, parameters
    and statistics 1e-4; bf16 all 2e-2): the gathered parameters and
    statistics equal across the ranks, the replicated parameters bit for
    bit; the kernels' launches a rank and a step (rel-pos 30 / 30 on the
    rank's heads, the LM's bias 24 / 24, on the FMA route in fp32 and the
    tensor cores in bf16), the model groups' all-reduces and all-gathers a
    step (over gloo, the all-gathers take the card's tensors as they are).
    The fp32 CTC gradient moves with the rounding of the logits
    (its posteriors are exp(alpha + beta - loss), the loss a few hundred
    nats, whose fp32 ulp is ~3e-5), so the fp32 CTC norm is held to the
    larger of 1e-5 and three times its noise floor: how far the one-process
    step moves with its logits rounded from a float64 product
    (``float64_head``). The fp32 CTC step runs again with its loss in
    float64 on both sides (``float64_loss``), its norm held to 1e-5:
    the lattice's fp32 rounding, not the split, is what moves the norm. The
    fp32 Transducer's norm, moved by its fp32 RNN-T lattice alike, is held
    to 1e-4, and to 1e-5 with its loss in float64. Each fp32 norm also
    stands beside the one-process step's with its vocabulary product split
    into the model group's column GEMMs (``split_head``, norm_rel_split).
    ``cut`` cuts ``tp_cases``' depth. ``cases`` (by default ``tp_cases``'s)
    may hold layers whose width the model size does not divide: they run
    replicated, and the line prints
    the replicated tensors a rank holds against ``placement_of``'s count
    (the model group all-gathers only where something is split). The
    ``extra`` cases ([dp-slice]'s, whose ranks set no grid) run first in the
    same launch of ranks. Returns the kernels' launches over the ranks and
    steps: {"relpos": (fwd, bwd), "bias": (fwd, bwd)}, those norms by model
    ("norm_rel_split"), and the extra cases' results of each rank and the
    launch's seconds ("extra")."""
    from efficientconformer_torch import dryrun
    from efficientconformer_torch.models import factory
    from efficientconformer_torch.parallel import mesh, tensor

    cases = tp_cases(ranks, model_parallel, lm, cut=cut) if cases is None else cases
    splits = {}
    sharded = []
    for case in cases:
        cfg = json.loads(json.dumps(case["config"]))
        cfg["training_params"]["model_parallel"] = model_parallel
        sharded.append(in_rank(dict(case, config=cfg)))
    t0 = time.perf_counter()
    outs = mesh.launch(rank_steps, ranks, ([in_rank(c) for c in extra] + sharded,),
                       device_type="cuda", backend=backend, timeout=TP_TIMEOUT + DP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    extra_outs = [o[:len(extra)] for o in outs]
    outs = [o[len(extra):] for o in outs]
    backend = backend or mesh.default_backend("cuda")
    total = {"relpos": [0, 0], "bias": [0, 0]}
    for i, case in enumerate(cases):
        cfg = case["config"]
        is_lm = "lm_params" in cfg
        is_t = cfg["model_type"] == "Transducer"
        f64 = case.get("float64_loss", False)
        fp32 = not cfg["training_params"]["mixed_precision"]
        one = one_process(case)
        got = [o[i] for o in outs]
        loss_err = max(abs(g["loss"] - one["loss"]) / abs(one["loss"]) for g in got)
        norm_err = max(abs(g["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
                       for g in got)
        stats = [{k: v for k, v in g["buffers"].items() if "running" in k} for g in got + [one]]
        param_err = max(rel_diff(g["params"], one["params"]) for g in got)
        stats_err = max(rel_diff(st, stats[-1]) for st in stats[:-1])
        tol, loss_tol = (DP_FP32_TOL, DP_LOSS_RTOL) if fp32 else (DP_BF16_TOL, DP_BF16_TOL)
        norm_tol, floor = loss_tol, None
        split = None
        if fp32 and not is_lm and not f64:
            with float64_head():
                moved = dryrun.shard_step(**case, device="cuda")
            floor = abs(moved["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
            # the fp32 RNN-T lattice's rounding moves the Transducer's, as the
            # CTC lattice's moves the CTC norm ([sp-slice])
            norm_tol = DP_FP32_TOL if is_t else max(loss_tol, 3 * floor)
            with split_head(model_parallel):
                laid = dryrun.shard_step(**case, device="cuda")
            split = max(abs(g["grad_norm"] - laid["grad_norm"]) / abs(laid["grad_norm"])
                        for g in got)
        name = "LM" if is_lm else "Transducer" if is_t else "CTC"
        label = f"[{phase}] {name} {'fp32' if fp32 else 'bf16'}{' float64 loss' if f64 else ''}"
        if split is not None:
            splits[name] = split
        check(loss_err <= loss_tol and norm_err <= norm_tol,
              f"{label}: loss {[g['loss'] for g in got]} / {one['loss']}, "
              f"norm {[g['grad_norm'] for g in got]} / {one['grad_norm']}")
        check(param_err <= tol and stats_err <= tol,
              f"{label}: parameters {param_err}, statistics {stats_err}")
        differ = [(key, k, (g[key][k].double() - got[0][key][k].double()).abs().max().item())
                  for g in got[1:] for key in ("params", "buffers") for k in got[0][key]
                  if not torch.equal(g[key][k], got[0][key][k])]
        check(not differ, f"{label}: the ranks' gathered parameters or statistics differ: "
              f"{differ[:8]} ({len(differ)} in all)")
        check(all(torch.equal(g["replicated"][k], got[0]["replicated"][k]) for g in got[1:]
                  for k in got[0]["replicated"]) and got[0]["replicated"],
              f"{label}: the ranks' replicated parameters differ")
        kernel, n_att = (("bias", cfg["lm_params"]["num_blocks"] * 2) if is_lm else
                         ("relpos", cfg["encoder_params"]["num_blocks"] * 2))
        model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(SEED))
        placement = tensor.param_placement(model, model_parallel)
        names = {n for n, _ in model.named_parameters()}
        replicated = sum(placement[n].kind == "replicated" for n in names)
        n_split = len(names) - replicated
        del model
        check(all(len(g["replicated"]) == replicated for g in got),
              f"{label}: replicated parameters {[len(g['replicated']) for g in got]}, "
              f"placement_of replicates {replicated}")
        per_rank = []
        for g in got:
            c = g["launches"]
            fwd, bwd = c[f"{kernel}_fwd"], c[f"{kernel}_bwd"]
            tc = (c[f"{kernel}_fwd_tc"], c[f"{kernel}_bwd_tc"])
            per_rank.append((fwd, bwd))
            check((fwd, bwd) == (n_att, n_att) and tc == ((0, 0) if fp32 else (n_att, n_att)),
                  f"{label} rank {g['rank']}: {kernel} launches {c}, expected {n_att} / "
                  f"{n_att} on the {'FMA' if fp32 else 'tensor-core'} route")
            check(g["model_size"] == model_parallel and g["tp_calls"]["all_reduce"] > 0
                  and (g["tp_calls"]["all_gather"] > 0) == (n_split > 0)
                  and g["ddp"] == (ranks > model_parallel),
                  f"{label} rank {g['rank']}: model size {g['model_size']}, collectives "
                  f"{g['tp_calls']}, DDP {g['ddp']}")
            total[kernel] = [total[kernel][0] + fwd, total[kernel][1] + bwd]
        say(phase, model=cfg["model_name"].replace(" ", ""),
            dtype="float32" if fp32 else "bfloat16", ranks=ranks,
            loss_type="float64" if f64 else "float32",
            grid=f"data{ranks // model_parallel}xmodel{model_parallel}", backend=backend,
            rows=case["batch"]["audio" if not is_lm else "tokens"].shape[:2],
            loss=f"{got[0]['loss']:.6f}", loss_rel=f"{loss_err:.3g}",
            norm_rel=f"{norm_err:.3g}", norm_tol=f"{norm_tol:.3g}",
            norm_floor="-" if floor is None else f"{floor:.3g}",
            norm_rel_split="-" if split is None else f"{split:.3g}",
            param_rel=f"{param_err:.3g}",
            stats_rel=f"{stats_err:.3g}", tol=tol, replicated_bitwise_equal=True,
            replicated_params=replicated, split_params=n_split,
            blocks=cfg.get("encoder_params", cfg.get("lm_params"))["num_blocks"],
            **{f"{kernel}_launches_per_rank": per_rank},
            route="fma" if fp32 else "tensor-core",
            all_reduces_per_step=got[0]["tp_calls"]["all_reduce"],
            all_gathers_per_step=got[0]["tp_calls"]["all_gather"],
            ddp_all_reduces=got[0]["ddp_all_reduces"], bn_all_reduces=got[0]["bn_all_reduces"],
            ranks_seconds=f"{ranks_s:.2f}", card=f"'{card_line}'")
    out = {k: tuple(v) for k, v in total.items()}
    out["norm_rel_split"] = splits
    out["extra"] = (extra_outs, ranks_s)
    return out


def phase_tp3_slice(card_line):
    """[tp3-slice]: tensor parallelism where the model size does not divide
    the widths, as the JAX mesh runs it: three ranks on the one card over
    gloo, one model group (data 1 x model 3). Conformer CTC Small (width
    176, FFN 704, 4 heads, 256 words: every layer replicated) one fp32 and
    one bf16 step, EfficientConformer CTC Small (120 / 168 / 240 split, 4
    heads on the gather path, its 256-word ``fc`` replicated) one fp32 step,
    each at one block a stage and at full width, the fp32 steps with the
    CTC loss in float64; held by ``phase_tp_slice`` to the one-process step
    at [tp-slice]'s gates, the replicated parameters bit for bit equal
    across the ranks and counted against ``placement_of``. Returns the
    rel-pos launches over the ranks and steps."""
    rng = np.random.default_rng(SEED + 98)
    batch = tp_rows(TP3_RANKS, TP3_RANKS, rng)
    cases = []
    for path, mixed in ((TP3_CONFIG, False), (TP3_CONFIG, True), (CONFIG, False)):
        cfg = train_config(path, mixed_precision=mixed, lr_schedule="Constant", lr_value=1e-3)
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        cfg["encoder_params"] = one_block_a_stage(cfg["encoder_params"])
        cases.append({"config": cfg, "batch": batch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False, "float64_loss": not mixed})
    return phase_tp_slice(card_line, ranks=TP3_RANKS, model_parallel=TP3_RANKS,
                          phase="tp3-slice", cases=cases)["relpos"]


def phase_tp_cli():
    """[tp-cli]: ``-m training --model_parallel 2`` on a machine of one GPU
    is refused before any rank starts, with the JAX package's message (the
    CLI's ranks run one a GPU over NCCL; scripts/torch_tp_multigpu.py runs
    it on four). Returns whether it ran (more than one GPU) or was refused."""
    from efficientconformer_torch import main as cli_main

    n = torch.cuda.device_count()
    if n % 2 == 0:
        say("tp-cli", gpus=n, note="run by scripts/torch_tp_multigpu.py")
        return "not run"
    try:
        cli_main.main(["-c", CONFIG, "-m", "training", "--model_parallel", "2"])
    except ValueError as e:
        check(f"does not divide the {n} visible" in str(e), f"[tp-cli] {e}")
        say("tp-cli", gpus=n, refused=f"'{e}'")
        return "refused"
    raise RuntimeError("[tp-cli] --model_parallel 2 on one GPU was not refused")


# ---------------------------------------------------------------- sequence parallelism


def sp_cut(enc_params, samples, seq, rank):
    """``cut(name, args)`` for check_forward / check_backward: the inputs of
    a stage cut to the query rows seq rank ``rank`` of ``seq`` computes at
    ``samples`` of audio (its frames; in a grouped stage the groups that
    cover them), the position table's rows from its first row on: Nq rows
    against all Nk keys."""
    from efficientconformer_torch.parallel import mesh, sequence
    from efficientconformer_torch.parallel.tensor import Region

    frames = sorted(set(mesh.seq_frame_schedule(enc_params, samples)[1:]), reverse=True)
    names = [shape[0] for shape in stage_shapes(enc_params, samples / SAMPLE_RATE)]
    rows = {}
    for name, t, (_, _, _, _, _, g) in zip(names, frames,
                                           stage_shapes(enc_params, samples / SAMPLE_RATE)):
        span = sequence.even(t, Region(None, rank, seq))
        rows[name] = (sequence.covering(span, g) if g > 1 else
                      (span.start, span.start + span.length))

    def cut(name, args):
        r0, r1 = rows[name]
        qu, rowtab = args[0][:, :, r0:r1].contiguous(), args[5][r0:r1]
        return (qu, *args[1:5], rowtab, *args[6:])

    return cut


def phase_sp_kernel():
    """[sp-kernel]: both rel-pos kernels at sequence parallelism's shapes,
    the flagship's 16 s stage shapes padded by sp_pad_align with seq rank
    r's query rows against all T keys (seq 2: ranks 0 and 1; seq 4: ranks
    0, 2 and 3, offsets 0, T/2, 3T/4; the grouped stage's rows the groups
    covering a rank's frames), against their plain versions as [kernel] and
    [kernel-bwd] check them: fp32 on the FMA route and bf16 on the tensor
    cores. Returns the largest errors: forward (fp32, bf16), backward (fp32,
    bf16)."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.parallel import mesh

    enc_params = load_config(CONFIG)["encoder_params"]
    gen = torch.Generator().manual_seed(SEED + 95)
    fwd, bwd = [0.0, 0.0], [0.0, 0.0]
    for seq, ranks in SP_KERNEL_RANKS.items():
        samples = mesh.sp_pad_align(enc_params, seq)(round(TRAIN_SECONDS * SAMPLE_RATE))
        for rank in ranks:
            cut = sp_cut(enc_params, samples, seq, rank)
            say("sp-kernel-rows", seq=seq, rank=rank, samples=samples,
                frames=sorted(set(mesh.seq_frame_schedule(enc_params, samples)[1:]),
                              reverse=True))
            e = check_forward("sp-kernel", enc_params, samples / SAMPLE_RATE, gen, cut=cut)
            fwd = [max(a, b) for a, b in zip(fwd, e)]
            e = check_backward("sp-kernel-bwd", enc_params, samples / SAMPLE_RATE, gen, cut=cut)
            bwd = [max(a, b) for a, b in zip(bwd, e)]
    return fwd, bwd, sp_bias_kernel(gen)


def sp_bias_kernel(gen):
    """[sp-kernel]'s bias rows: both bias kernels at the causal 4-head
    Large's stage shapes (causal_wide_encoder, B 2, 8 s at sp_pad_align's
    length; stage 1 grouped, head 270: the chunked routes) with the query
    rows of seq rank r of 2 (rows from 0 and from N/2) against all N keys
    under the causal bias's rows, fp32 and bf16, forward and backward,
    against their plain versions at [lm-kernel]'s gates (check_bias_case).
    Returns the largest fp32 errors, (forward, backward)."""
    from efficientconformer_torch.parallel import mesh

    p = causal_wide_encoder()[1]
    samples = mesh.sp_pad_align(p, 2)(8 * SAMPLE_RATE)
    err = [0.0, 0.0]
    for name, n, dh, _, h, _ in stage_shapes(p, samples / SAMPLE_RATE):
        q, k, v, bias, scale = bias_inputs(2, h, n, n, dh, dh, "causal", gen)
        for rank in range(2):
            r0, r1 = rank * n // 2, (rank + 1) * n // 2
            e = check_bias_case(f"causal-large-{name}-seq2-rank{rank}",
                                (q[:, :, r0:r1], k, v, bias[:, :, r0:r1], scale), gen,
                                phase="sp-kernel-bias")
            err = [max(a, b) for a, b in zip(err, e)]
    return err


def sp_batch(rows, seconds, samples, rng):
    """2 microbatches of ``rows`` ragged utterances of ``seconds`` (2,
    rows), labels of 0-30 tokens, on the host, padded to ``samples``."""
    batch = {k: v.numpy() for k, v in train_batch(2, rows, seconds,
                                                  np.resize([12, 30, 0, 20], rows), "cpu",
                                                  rng).items()}
    audio = batch["audio"]
    batch["audio"] = np.pad(audio, [(0, 0), (0, 0), (0, samples - audio.shape[-1])])
    return batch


def sp_cases(ranks, seq, model=1, cut=False) -> list:
    """[sp-slice]'s steps ([dp-slice]'s settings: dropout 0, SpecAugment
    off, Adam from a shared non-zero state at a constant 1e-3), 2
    microbatches of 4 ragged utterances of 4-8 s a data rank: the
    flagship's fp32 step and Transducer Small's (each twice: with the loss
    in fp32 and in float64) and the flagship's bf16 step, padded by
    sp_pad_align;
    the flagship's fp32 step at SP_UNCOVERED samples, no point of the
    encoder dividing by 2. With ``cut`` the encoders at one block a stage,
    at full width (the stages' strides, and so the padding, unchanged)."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.parallel import mesh

    rows = 4 * (ranks // (seq * model))
    rng = np.random.default_rng(SEED + 96)
    seconds = np.resize([4.0, 5.5, 7.0, 8.0, 8.0, 6.5, 4.5, 5.0], (2, rows))
    enc_params = load_config(CONFIG)["encoder_params"]
    aligned = sp_batch(rows, seconds, mesh.sp_pad_align(enc_params, seq)(128000), rng)
    uncovered = sp_batch(rows, np.minimum(seconds, SP_UNCOVERED / SAMPLE_RATE), SP_UNCOVERED,
                         rng)
    cases = []
    for path, mixed, batch in ((CONFIG, False, aligned), (CONFIG, True, aligned),
                               (T_CONFIG, False, aligned), (CONFIG, False, uncovered)):
        cfg = train_config(path, mixed_precision=mixed, lr_schedule="Constant", lr_value=1e-3)
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        if cut:
            cfg["encoder_params"] = one_block_a_stage(cfg["encoder_params"])
        cases.append({"config": cfg, "batch": batch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False})
    # the fp32 steps again with their losses in float64 (``float64_loss``)
    cases.insert(1, dict(cases[0], float64_loss=True))
    cases.insert(4, dict(cases[3], float64_loss=True))
    return cases


def phase_sp_slice(card_line, ranks=SP_RANKS, seq=2, model=1, backend="gloo",
                   phase="sp-slice", cut=False, extra=()):
    """Sequence parallelism at full width: ``ranks`` ranks on a grid of
    data x ``seq`` x ``model`` (by default two on the one card over gloo,
    data 1 x seq 2; ``backend`` None: NCCL, one rank a GPU), each case of
    ``sp_cases`` against the one-process step over the global batch on the
    (first) card at [tp-slice]'s gates (fp32 loss 1e-5 and norm the larger
    of 1e-5 and three times its floor: how far the one-process step moves
    with its logits from a float64 vocabulary product; parameters and
    statistics 1e-4; bf16 all 2e-2), but for the fp32 norms: 1e-5 with the
    CTC or RNN-T loss in float64 on both sides, and with it in fp32 1e-4, as
    the fp32 lattice's rounding (~3e-5: posteriors exp(alpha + beta - L), L
    a few hundred nats) moves it wherever the forward's rounding changes and
    the float64 loss removes; the ranks' parameters and statistics
    bit for bit equal; a rank's rel-pos launches a step (30 / 30 on its
    query rows, FMA in fp32, tensor cores in bf16) and RNN-T launches; the
    seq group's all-gathers, halos and reduce-scatters a step (none at the
    uncovered length); each rank's peak memory beside the one-process
    step's. With ``cut`` the encoders' depth is cut (``sp_cases``). The
    ``extra`` cases ([sp-skew-slice]'s) run in the same launch of ranks.
    Returns the rel-pos (forward, backward) launches over the ranks and
    steps, and the extra cases' results of each rank and the launch's
    seconds."""
    from efficientconformer_torch import dryrun
    from efficientconformer_torch.parallel import mesh

    cases = sp_cases(ranks, seq, model, cut=cut)
    gridded = []
    for case in cases:
        cfg = json.loads(json.dumps(case["config"]))
        cfg["training_params"].update(seq_parallel=seq, model_parallel=model)
        gridded.append(in_rank(dict(case, config=cfg)))
    gridded += [in_rank(case) for case in extra]
    t0 = time.perf_counter()
    outs = mesh.launch(rank_steps, ranks, (gridded,), device_type="cuda",
                       backend=backend, timeout=SP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    backend = backend or mesh.default_backend("cuda")
    total = [0, 0]
    for i, case in enumerate(cases):
        cfg = case["config"]
        is_t = cfg["model_type"] == "Transducer"
        f64 = case.get("float64_loss", False)
        fp32 = not cfg["training_params"]["mixed_precision"]
        samples = case["batch"]["audio"].shape[-1]
        covered = mesh.sp_coverage(cfg["encoder_params"], seq, samples)
        one = one_process(case)
        got = [o[i] for o in outs]
        loss_err = max(abs(g["loss"] - one["loss"]) / abs(one["loss"]) for g in got)
        norm_err = max(abs(g["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
                       for g in got)
        stats = [{k: v for k, v in g["buffers"].items() if "running" in k} for g in got + [one]]
        param_err = max(rel_diff(g["params"], one["params"]) for g in got)
        stats_err = max(rel_diff(st, stats[-1]) for st in stats[:-1])
        tol, loss_tol = (DP_FP32_TOL, DP_LOSS_RTOL) if fp32 else (DP_BF16_TOL, DP_BF16_TOL)
        norm_tol, floor = loss_tol, None
        if fp32 and not f64:
            with float64_head():
                moved = dryrun.shard_step(**case, device="cuda")
            floor = abs(moved["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
            norm_tol = DP_FP32_TOL
        label = (f"[{phase}] {'Transducer' if is_t else 'CTC'} {'fp32' if fp32 else 'bf16'}"
                 f"{' float64 loss' if f64 else ''} {samples} samples")
        check(loss_err <= loss_tol and norm_err <= norm_tol,
              f"{label}: loss {[g['loss'] for g in got]} / {one['loss']}, "
              f"norm {[g['grad_norm'] for g in got]} / {one['grad_norm']} (tol {norm_tol})")
        check(param_err <= tol and stats_err <= tol,
              f"{label}: parameters {param_err}, statistics {stats_err}")
        differ = [(key, k) for g in got[1:] for key in ("params", "buffers") for k in got[0][key]
                  if not torch.equal(g[key][k], got[0][key][k])]
        check(not differ, f"{label}: the ranks' parameters or statistics differ: "
              f"{differ[:8]} ({len(differ)} in all)")
        n_att = cfg["encoder_params"]["num_blocks"] * 2
        per_rank, calls = [], []
        for g in got:
            c = g["launches"]
            fwd, bwd = c["relpos_fwd"], c["relpos_bwd"]
            tc = (c["relpos_fwd_tc"], c["relpos_bwd_tc"])
            per_rank.append((fwd, bwd))
            calls.append(g["sp_calls"])
            check((fwd, bwd) == (n_att, n_att) and tc == ((0, 0) if fp32 else (n_att, n_att)),
                  f"{label} rank {g['rank']}: rel-pos launches {c}, expected {n_att} / "
                  f"{n_att} on the {'FMA' if fp32 else 'tensor-core'} route")
            check(not is_t or f64 or (c["rnnt_fwd"] > 0 and c["rnnt_bwd"] > 0),
                  f"{label} rank {g['rank']}: RNN-T launches {c}")
            sharded = covered[0] > 0
            exchanges = [g["sp_calls"][k] for k in ("all_gather", "halo", "reduce_scatter")]
            check(g["seq_size"] == seq and g["ddp"] and
                  (all(exchanges) and not g["sp_calls"]["all_reduce"] if sharded else
                   not any(g["sp_calls"].values())),
                  f"{label} rank {g['rank']}: seq size {g['seq_size']}, DDP {g['ddp']}, "
                  f"collectives {g['sp_calls']} at coverage {covered}")
            total = [total[0] + fwd, total[1] + bwd]
        say(phase, model=cfg["model_name"].replace(" ", ""),
            dtype="float32" if fp32 else "bfloat16", ranks=ranks,
            loss_type="float64" if f64 else "float32",
            grid=f"data{ranks // (seq * model)}xseq{seq}" + (f"xmodel{model}" if model > 1
                                                             else ""),
            backend=backend, rows=case["batch"]["audio"].shape[:2], samples=samples,
            coverage=f"{covered[0]}/{covered[1]}", loss=f"{got[0]['loss']:.6f}",
            loss_rel=f"{loss_err:.3g}", norm_rel=f"{norm_err:.3g}", norm_tol=f"{norm_tol:.3g}",
            norm_floor="-" if floor is None else f"{floor:.3g}", param_rel=f"{param_err:.3g}",
            stats_rel=f"{stats_err:.3g}", tol=tol, bitwise_equal_across_ranks=True,
            relpos_launches_per_rank=per_rank, route="fma" if fp32 else "tensor-core",
            seq_collectives_per_step=calls[0],
            model_collectives_per_step=got[0]["tp_calls"] if model > 1 else "-",
            peak_gib_per_rank=[gib(g["peak_bytes"]) for g in got],
            peak_gib_one_process=gib(one["peak_bytes"]),
            ddp_all_reduces=got[0]["ddp_all_reduces"], bn_all_reduces=got[0]["bn_all_reduces"],
            ranks_seconds=f"{ranks_s:.2f}", card=f"'{card_line}'")
    return tuple(total), [o[len(cases):] for o in outs], ranks_s


def gib(nbytes) -> str:
    return "-" if nbytes is None else f"{nbytes / 2**30:.3f}"


def sp_skew_cases(seq=2) -> list:
    """[sp-skew-slice]'s steps: [causal-wide-slice]'s causal 4-head
    EfficientConformer CTC Large at full width, one block a stage, on a data
    1 x seq ``seq`` grid: one fp32 step (its CTC loss in float64) and one
    bf16 step over 2 x 4 ragged rows of 4-8 s padded by sp_pad_align (dropout
    0, SpecAugment off, Adam from dp_adam's state at a constant 1e-3)."""
    from efficientconformer_torch.parallel import mesh

    cfg0, p = causal_wide_encoder()
    p = one_block_a_stage(dict(p, Pdrop=0.0, spec_augment=False))
    rng = np.random.default_rng(SEED + 99)
    seconds = np.resize([4.0, 5.5, 7.0, 8.0, 8.0, 6.5, 4.5, 5.0], (2, 4))
    batch = sp_batch(4, seconds, mesh.sp_pad_align(p, seq)(128000), rng)
    cases = []
    for mixed in (False, True):
        cfg = json.loads(json.dumps(cfg0))
        cfg["encoder_params"] = p
        cfg["training_params"].update(mixed_precision=mixed, lr_schedule="Constant",
                                      lr_value=1e-3, seq_parallel=seq, model_parallel=1)
        cases.append({"config": cfg, "batch": batch, "seed": SEED, "adam": dp_adam(cfg),
                      "allow_tf32": False, "float64_loss": not mixed})
    return cases


def phase_sp_skew_slice(card_line, cases, outs, ranks_s, seq=2):
    """[sp-skew-slice]: sequence parallelism through the skewing path on
    the card: ``sp_skew_cases``' steps, run on two ranks sharing the card
    over gloo (data 1 x seq 2) in [sp-slice]'s launch (``outs``: each
    rank's results, ``ranks_s`` that launch's seconds): each rank's query
    rows (stage 1's covering groups, head 270: the chunked routes) against
    the gathered keys on the bias kernels (Nq < Nk), the rel scores skewed
    at the rank's row offset; held to the one-process step at [sp-slice]'s
    gates (fp32: loss and norm 1e-5, parameters and statistics 1e-4; bf16
    2e-2), the ranks' parameters and statistics bit for bit equal; a
    rank's bias launches (a block a direction a microbatch, none on the
    rel-pos kernels) and their routes, and the seq group's exchanges.
    Returns the bias launches over the ranks and steps, and the chunked
    ones: (fwd, bwd, chunked fwd, chunked bwd)."""
    total = [0, 0, 0, 0]
    for i, case in enumerate(cases):
        p = case["config"]["encoder_params"]
        n_att = p["num_blocks"] * 2
        fp32 = not case["config"]["training_params"]["mixed_precision"]
        one_case = json.loads(json.dumps(case["config"]))
        one_case["training_params"].update(seq_parallel=1)
        one = one_process(dict(case, config=one_case))
        got = [o[i] for o in outs]
        label = f"[sp-skew-slice] {'fp32 float64 loss' if fp32 else 'bf16'}"
        tol, loss_tol = (DP_FP32_TOL, DP_LOSS_RTOL) if fp32 else (DP_BF16_TOL, DP_BF16_TOL)
        loss_err = max(abs(g["loss"] - one["loss"]) / abs(one["loss"]) for g in got)
        norm_err = max(abs(g["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
                       for g in got)
        stats = [{k: v for k, v in g["buffers"].items() if "running" in k} for g in got + [one]]
        param_err = max(rel_diff(g["params"], one["params"]) for g in got)
        stats_err = max(rel_diff(st, stats[-1]) for st in stats[:-1])
        check(all(math.isfinite(g["loss"]) for g in got), f"{label}: loss {got[0]['loss']}")
        check(loss_err <= loss_tol and norm_err <= loss_tol,
              f"{label}: loss {[g['loss'] for g in got]} / {one['loss']}, "
              f"norm {[g['grad_norm'] for g in got]} / {one['grad_norm']}")
        check(param_err <= tol and stats_err <= tol,
              f"{label}: parameters {param_err}, statistics {stats_err}")
        differ = [(key, k) for g in got[1:] for key in ("params", "buffers") for k in got[0][key]
                  if not torch.equal(g[key][k], got[0][key][k])]
        check(not differ, f"{label}: the ranks' parameters or statistics differ: {differ[:8]}")
        per_rank, routes = [], []
        for g in got:
            c = g["launches"]
            chunked = tuple(sum(v for r, v in d.items() if r.endswith("_chunked"))
                            for d in g["routes"])
            per_rank.append((c["bias_fwd"], c["bias_bwd"]))
            routes.append(g["routes"])
            check((c["bias_fwd"], c["bias_bwd"]) == (n_att, n_att)
                  and (c["relpos_fwd"], c["relpos_bwd"]) == (0, 0) and chunked == (2, 2),
                  f"{label} rank {g['rank']}: launches {c}, routes {g['routes']}, expected "
                  f"{n_att} / {n_att} on the bias kernels, 2 / 2 of them chunked")
            calls = g["sp_calls"]
            check(g["seq_size"] == seq and calls["all_gather"] > 0 and calls["halo"] > 0
                  and calls["reduce_scatter"] > 0,
                  f"{label} rank {g['rank']}: seq collectives {calls}")
            total = [total[0] + c["bias_fwd"], total[1] + c["bias_bwd"],
                     total[2] + chunked[0], total[3] + chunked[1]]
        say("sp-skew-slice", model=CAUSAL_WIDE_MODEL, causal=True, blocks=p["num_blocks"],
            dtype="float32" if fp32 else "bfloat16", loss_type="float64" if fp32 else "bfloat16",
            ranks=len(got), grid=f"data1xseq{seq}", rows=case["batch"]["audio"].shape[:2],
            samples=case["batch"]["audio"].shape[-1], loss=f"{got[0]['loss']:.6f}",
            loss_rel=f"{loss_err:.3g}", norm_rel=f"{norm_err:.3g}",
            param_rel=f"{param_err:.3g}", stats_rel=f"{stats_err:.3g}", tol=tol,
            bitwise_equal_across_ranks=True, bias_launches_per_rank=per_rank,
            routes_per_rank=routes, seq_collectives_per_step=got[0]["sp_calls"],
            peak_gib_per_rank=[gib(g["peak_bytes"]) for g in got],
            peak_gib_one_process=gib(one["peak_bytes"]),
            shared_launch_seconds=f"{ranks_s:.2f}", card=f"'{card_line}'")
    return tuple(total)


def phase_contextnet():
    """[contextnet]: ContextNetSubsampling (CONTEXTNET: 80 mels, 240
    features, kernel 5; eight blocks, two of stride 2) on 2 x 10 s of random
    features (1,001 frames, one row 8 s long), fp32 on the card against the
    same module on the CPU within CONTEXTNET_TOL, in train mode (batch
    statistics; the running statistics it leaves behind too) and in eval
    mode (the running statistics moved off their init); the lengths equal.
    Returns the largest error."""
    from efficientconformer_torch.models.layers import init_weights_
    from efficientconformer_torch.models.modules import ContextNetSubsampling

    mels, features, kernel = CONTEXTNET
    gen = torch.Generator().manual_seed(SEED + 97)
    module = ContextNetSubsampling(mels, features, kernel)
    init_weights_(module, gen)
    perturb_norms_(module)
    x = torch.randn(2, 1001, mels, generator=gen)
    x_len = torch.tensor([1001, 801])
    worst = 0.0
    for train in (True, False):
        cpu = copy.deepcopy(module).train(train)
        card = copy.deepcopy(module).cuda().train(train)
        t0 = time.perf_counter()
        with torch.no_grad():
            y, y_len = card(x.cuda(), x_len.cuda())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want, want_len = cpu(x, x_len)
        err = (y.cpu() - want).abs().max().item() / max(want.abs().max().item(), 1.0)
        stats = 0.0
        if train:
            stats = rel_diff({k: v.cpu() for k, v in card.state_dict().items() if "running" in k},
                             {k: v for k, v in cpu.state_dict().items() if "running" in k})
        check(y_len.cpu().tolist() == want_len.tolist() and err <= CONTEXTNET_TOL
              and stats <= CONTEXTNET_TOL,
              f"[contextnet] {'train' if train else 'eval'}: output {err}, statistics {stats}, "
              f"lengths {y_len.tolist()} / {want_len.tolist()}")
        worst = max(worst, err, stats)
        say("contextnet", mode="train" if train else "eval", input=tuple(x.shape),
            features=features, kernel=kernel, output=tuple(y.shape), lengths=y_len.tolist(),
            rel_err=f"{err:.3g}", stats_rel_err=f"{stats:.3g}", tol=CONTEXTNET_TOL,
            card_ms=f"{ms:.2f}")
    return worst


def phase_sp_cli():
    """[sp-cli]: ``-m training --seq_parallel 2`` on a machine of one GPU is
    refused before any rank starts, with the JAX package's message
    (scripts/torch_sp_multigpu.py runs sequence parallelism on four).
    Returns whether it was refused or not run (an even GPU count)."""
    from efficientconformer_torch import main as cli_main

    n = torch.cuda.device_count()
    if n % 2 == 0:
        say("sp-cli", gpus=n, note="run by scripts/torch_sp_multigpu.py")
        return "not run"
    try:
        cli_main.main(["-c", CONFIG, "-m", "training", "--seq_parallel", "2"])
    except ValueError as e:
        check(f"model_parallel=1 x seq_parallel=2 does not divide the {n} visible" in str(e),
              f"[sp-cli] {e}")
        say("sp-cli", gpus=n, refused=f"'{e}'")
        return "refused"
    raise RuntimeError("[sp-cli] --seq_parallel 2 on one GPU was not refused")


# ---------------------------------------------------------------- Transducer


def phase_t_kernel(t_enc):
    """Both rel-pos kernels at Transducer Small's 16 s stage shapes."""
    gen = torch.Generator().manual_seed(SEED + 5)
    return (check_forward("t-kernel", t_enc, TRAIN_SECONDS, gen),
            check_backward("t-kernel-bwd", t_enc, TRAIN_SECONDS, gen))


def rnnt_inputs(b, t, u1, seed):
    """Gathered blank / emit log-probs (B, T, U+1) of about the size a
    1000-token vocabulary gives, and ragged lengths on the card: the first
    utterance has f_len = T and y_len = U, the last of two or more y_len =
    0."""
    gen = torch.Generator().manual_seed(seed)
    lp = (torch.randn(b, t, u1, 3, generator=gen) * 2).log_softmax(-1) - math.log(333.0)
    f_len = torch.linspace(t, max(t // 3, 1), b).round().int()
    y_len = torch.linspace(0, u1 - 1, b).round().int().flip(0)
    y_len[-1] = 0 if b > 1 else u1 - 1
    return [x.cuda() for x in (lp[..., 0].contiguous(), lp[..., 1].contiguous(), f_len, y_len)]


def rnnt_cost(blank, f_len, y_len, backward):
    """(operations, bytes) the lattice pass must do at these lengths: the
    forward covers the whole (T, U+1) lattice (reads blank and emit, writes
    the alphas and the loss), about 10 fp32 operations a cell; the backward
    reads alpha, blank and emit inside each utterance's lattice and writes
    both gradients everywhere, about 20 operations an inside cell."""
    b, t, u1 = blank.shape
    cells = b * t * u1
    if not backward:
        return 10 * cells, 4 * (3 * cells + b) + 8 * b
    inside = int((f_len.long() * (y_len.long() + 1)).sum())
    return 20 * inside, 4 * (3 * inside + 2 * cells + b) + 8 * b


def phase_rnnt_kernel(t_cfg):
    """Both RNN-T kernels vs their plain versions on the same inputs (the
    backward on the kernel's alphas and loss), at the training shape and at
    U+1 > 128; then both timed at the training shape."""
    from efficientconformer_torch.config import encoder_output_frames
    from efficientconformer_torch.ops import rnnt_loss as RL

    tp = t_cfg["training_params"]
    shape = (tp["batch_size"], encoder_output_frames(t_cfg["encoder_params"],
                                                     tp["train_audio_max_length"]),
             tp["train_label_max_length"] + 1)
    err_f = err_b = 0.0
    for i, (b, t, u1) in enumerate((shape, RNNT_WIDE)):
        blank, emit, f_len, y_len = rnnt_inputs(b, t, u1, SEED + 6 + i)
        alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
        grads = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
        e_f, e_b, fields = rnnt_check(b, t, u1, blank, emit, f_len, y_len, alphas, loss, grads,
                                      "rnnt-kernel")
        err_f, err_b = max(err_f, e_f), max(err_b, e_b)
        say("rnnt-kernel", B=b, T=t, U1=u1, f_len=f"{int(f_len.min())}..{int(f_len.max())}",
            y_len=f"{int(y_len.min())}..{int(y_len.max())}", **fields)

    blank, emit, f_len, y_len = rnnt_inputs(*shape, SEED + 6)
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    n_diags = (shape[1] + shape[2] - 1, int((f_len + y_len).max()))
    calls = ((lambda: RL.rnnt_alphas(blank, emit, f_len, y_len),
              lambda: plain_rnnt_alphas(blank, emit, f_len, y_len)),
             (lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss),
              lambda: RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)))
    times = []
    for backward, (kernel, plain) in enumerate(calls):
        row = {"kernel": graph_ms(kernel), "plain": cuda_ms(plain, iters=3, warmup=1),
               "library": None}
        row["bound"], row["bound_by"] = bound(*rnnt_cost(blank, f_len, y_len, backward),
                                              peak=FP32_PEAK)
        threads, _, ring, smem = RL.launch_geometry(shape[2])
        say("rnnt-kernel-time", direction="backward" if backward else "forward",
            B=shape[0], T=shape[1], U1=shape[2], threads=threads, ring=ring, smem_bytes=smem,
            bound_by=row["bound_by"], kernel_ms=f"{row['kernel']:.4f}",
            eager_ms=f"{cuda_ms(kernel):.4f}", plain_ms=f"{row['plain']:.4f}",
            bound_ms=f"{row['bound']:.6f}", library_ms="none (no torchaudio)",
            n_diag=n_diags[backward],
            us_per_diagonal=f"{1e3 * row['kernel'] / n_diags[backward]:.3f}")
        times.append(row)
    return err_f, times[0], err_b, times[1]


def ptxas_rows(report: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the RNN-T
    kernels from nvcc's -Xptxas -v report, by name and template argument
    (rnnt_fwd_strip_kernel<2>, rnnt_grad_kernel<int64>)."""
    rows, name, spill = {}, None, (0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            k = re.search(r"(rnnt_[a-z_]+_kernel)(?:I(?:Li(\d+)E|([il]))E)?", entry.group(1))
            arg = k and (k.group(2) or {"i": "int", "l": "int64", None: ""}[k.group(3)])
            name = k and k.group(1) + (f"<{arg}>" if arg else "")
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found:
            spill = (int(found.group(1)), int(found.group(2)))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            rows[name], name = (int(found.group(1)), *spill), None
    return rows


def rnnt_check(b, t, u1, blank, emit, f_len, y_len, alphas, loss, grads, phase):
    """(forward error, backward error, line fields) of both RNN-T kernels'
    outputs vs their plain versions on the same inputs (the backward on the
    kernel's alphas and loss), the plain versions' ms on the host clock;
    exact zeros outside each lattice checked."""
    from efficientconformer_torch.ops import rnnt_loss as RL

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_a, want_l = plain_rnnt_alphas(blank, emit, f_len, y_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_g = RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    alpha_err = (alphas - want_a).abs().max().item()
    alpha_rel = alpha_err / max(want_a.abs().max().item(), 1.0)
    loss_rel = ((loss - want_l).abs() / want_l.abs()).max().item()
    grad_err = max((g - w).abs().max().item() for g, w in zip(grads, want_g))
    check(loss_rel <= RNNT_LOSS_RTOL and alpha_rel <= RNNT_LOSS_RTOL,
          f"[{phase}] {b}x{t}x{u1}: loss {loss_rel}, alphas {alpha_rel} > {RNNT_LOSS_RTOL}")
    check(grad_err <= RNNT_GRAD_TOL, f"[{phase}] backward {b}x{t}x{u1}: {grad_err}")
    inside = ((torch.arange(t, device="cuda")[None, :, None] < f_len[:, None, None].long())
              & (torch.arange(u1, device="cuda")[None, None, :] <= y_len[:, None, None].long()))
    check(all(bool((g[~inside] == 0).all()) for g in grads),
          f"[{phase}] non-zero gradient outside a lattice")
    bitwise = (torch.equal(alphas, want_a) and torch.equal(loss, want_l)
               and all(torch.equal(g, w) for g, w in zip(grads, want_g)))
    fields = {"loss_rel_err": f"{loss_rel:.3g}", "alpha_abs_err": f"{alpha_err:.3g}",
              "alpha_rel_err": f"{alpha_rel:.3g}", "grad_abs_err": f"{grad_err:.3g}",
              "bitwise_equal": bitwise, "plain_fwd_ms": f"{1e3 * (t1 - t0):.1f}",
              "plain_bwd_ms": f"{1e3 * (t2 - t1):.1f}"}
    return max(alpha_err, (loss - want_l).abs().max().item()), grad_err, fields


def phase_rnnt_long_kernel(ptxas):
    """Both RNN-T kernels on their strip routes vs their plain versions at
    RNNT_LONG_SHAPES, each call on the route launch_geometry names (strip
    launches counted); ptxas' registers and spills of the strip, read-back
    and gradient kernels; both timed (device time from CUDA graphs of 5
    calls) beside the plain versions (host clock, one call) and the bound,
    and where the strip is held in registers, beside the same strips read
    back (readback_ms, forward/backward; results equal bit for bit).
    Returns (forward error, backward error, {shape: times})."""
    from efficientconformer_torch.ops import rnnt_loss as RL

    for name, (regs, stores, loads) in sorted(ptxas.items()):
        say("rnnt-long-ptxas", kernel=name, registers=regs, spill_stores=stores,
            spill_loads=loads)
    err_f = err_b = 0.0
    rows = {}
    for i, (b, t, u1) in enumerate(RNNT_LONG_SHAPES):
        blank, emit, f_len, y_len = rnnt_inputs(b, t, u1, SEED + 20 + i)
        threads, strip, ring, smem = RL.launch_geometry(u1)
        RL.rnnt_alphas.strip_launches = RL.rnnt_grads.strip_launches = 0
        alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
        grads = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
        check(RL.rnnt_alphas.strip_launches == 1 and RL.rnnt_grads.strip_launches == 1,
              f"[rnnt-long-kernel] U+1 {u1} missed the strip route")
        e_f, e_b, fields = rnnt_check(b, t, u1, blank, emit, f_len, y_len, alphas, loss, grads,
                                      "rnnt-long-kernel")
        err_f, err_b = max(err_f, e_f), max(err_b, e_b)
        row = {"fwd": graph_ms(lambda: RL.rnnt_alphas(blank, emit, f_len, y_len), 5, 3),
               "bwd": graph_ms(lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss),
                               5, 3),
               "plain_fwd": float(fields["plain_fwd_ms"]),
               "plain_bwd": float(fields["plain_bwd_ms"])}
        for key, backward in (("fwd", False), ("bwd", True)):
            row[f"{key}_bound"], row[f"{key}_bound_by"] = bound(
                *rnnt_cost(blank, f_len, y_len, backward), peak=FP32_PEAK)
        readback = "none"
        if strip <= RL.STRIP_MAX:   # the same strips read back, no ring: what registers buy
            with mock.patch.object(RL, "launch_geometry",
                                   lambda n: (threads, strip, 0, 4 * RL.EDGE)):
                rb = RL.rnnt_alphas(blank, emit, f_len, y_len)
                rb_g = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
                check(all(torch.equal(x, y) for x, y in zip((*rb, *rb_g), (alphas, loss, *grads))),
                      f"[rnnt-long-kernel] U+1 {u1}: the read-back route differs")
                row["readback_fwd"] = graph_ms(lambda: RL.rnnt_alphas(blank, emit, f_len, y_len),
                                               5, 3)
                row["readback_bwd"] = graph_ms(
                    lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss), 5, 3)
                readback = f"{row['readback_fwd']:.4f}/{row['readback_bwd']:.4f}"
        n_diag = (t + u1 - 1, int((f_len + y_len).max()))
        rows[(b, t, u1)] = row
        say("rnnt-long-kernel", B=b, T=t, U1=u1, threads=threads, strip=strip, ring=ring,
            smem_bytes=smem, route="strip" if strip <= RL.STRIP_MAX else "readback",
            f_len=f"{int(f_len.min())}..{int(f_len.max())}",
            y_len=f"{int(y_len.min())}..{int(y_len.max())}", **fields,
            fwd_ms=f"{row['fwd']:.4f}", bwd_ms=f"{row['bwd']:.4f}",
            readback_ms=readback, fwd_bound_ms=f"{row['fwd_bound']:.6f}",
            bwd_bound_ms=f"{row['bwd_bound']:.6f}",
            bound_by=f"{row['fwd_bound_by']}/{row['bwd_bound_by']}",
            us_per_diagonal=f"{1e3 * row['fwd'] / n_diag[0]:.3f}/"
                            f"{1e3 * row['bwd'] / n_diag[1]:.3f}")
    return err_f, err_b, rows


def phase_t_long_eval(card_line):
    """Transducer Small's evaluation loss, Trainer.eval_loss as the CLI's
    --eval_loss and the per-epoch validation loss call it, at full width in
    the config's own mixed precision (bf16 model, the fp32 lattice), random
    weights from SEED, on one T_LONG_SECONDS utterance carrying
    T_LONG_LABELS labels: its encoder runs the limited-context attention the
    config's max_pos_encoding gives past 200 s (the skewing path onto the
    bias kernel), and the (1, 3,751, 1,101) lattice the strip route. One
    warm-up call, then the counted and timed one: launches, ms, the
    encoder's and the loss's share (synchronised around each), the kernel's
    ms, peak memory. The loss vs the plain versions on the gathered
    log-probs the path handed the lattice, and the backward on them.
    Returns (the path's forward launches on the strip route, forward error,
    backward error, {ms})."""
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rnnt_loss as RL
    from efficientconformer_torch.training.trainer import Trainer

    trainer = Trainer(T_CONFIG, device="cuda", seed=SEED)
    perturb_norms_(trainer.model)
    rng = np.random.default_rng(SEED + 30)
    n = int(T_LONG_SECONDS * SAMPLE_RATE)
    batch = {"audio": torch.from_numpy((rng.standard_normal((1, n)) * 0.1).astype(np.float32)),
             "audio_len": torch.tensor([n]),
             "labels": torch.from_numpy(rng.integers(1, 1000, (1, T_LONG_LABELS))),
             "label_len": torch.tensor([T_LONG_LABELS])}
    seen, ms = {}, {}
    real = RL.rnnt_loss_from_gathered

    def gathered(blank_lp, emit_lp, f_len, y_len):
        seen.update(blank=blank_lp, emit=emit_lp, f_len=f_len.to(blank_lp.device, torch.int32),
                    y_len=y_len.to(blank_lp.device, torch.int32))
        return real(blank_lp, emit_lp, f_len, y_len)

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    encoder = trainer.model.encoder
    with mock.patch.object(RL, "rnnt_loss_from_gathered", gathered), \
            mock.patch.object(encoder, "forward", timed("encoder", encoder.forward)), \
            mock.patch.object(trainer, "loss_fn", timed("loss", trainer.loss_fn)):
        trainer.eval_loss(batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        RL.rnnt_alphas.strip_launches = RL.rnnt_grads.strip_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = trainer.eval_loss(batch)
        torch.cuda.synchronize()
        ms["eval"] = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd, rel_fwd, rel_bwd = launch_counts()
        strip = RL.rnnt_alphas.strip_launches
        bias = BA.bias_attention.launches
    blank, emit, f_len, y_len = (seen[k] for k in ("blank", "emit", "f_len", "y_len"))
    b, t, u1 = blank.shape
    check(bool(torch.isfinite(loss)), f"[t-long-eval] loss {float(loss)}")
    check(u1 == T_LONG_LABELS + 1 and fwd == 1 and strip == 1 and bwd == 0,
          f"[t-long-eval] lattice {tuple(blank.shape)}, RNN-T launches {fwd} / {bwd}, "
          f"strip {strip}")
    alphas, k_loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    grads = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -k_loss)
    check(torch.equal(k_loss.mean(), loss.float()),
          f"[t-long-eval] the path's loss {float(loss)} is not the kernel's {float(k_loss)}")
    e_f, e_b, fields = rnnt_check(b, t, u1, blank, emit, f_len, y_len, alphas, k_loss, grads,
                                  "t-long-eval")
    ms["kernel"] = graph_ms(lambda: RL.rnnt_alphas(blank, emit, f_len, y_len), 5, 3)
    ms["kernel_bwd"] = graph_ms(lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -k_loss),
                                5, 3)
    bound_ms, bound_by = bound(*rnnt_cost(blank, f_len, y_len, False), peak=FP32_PEAK)
    threads, strip_width, ring, smem = RL.launch_geometry(u1)
    with mock.patch.object(RL, "launch_geometry",
                           lambda n: (threads, strip_width, 0, 4 * RL.EDGE)):
        rb = RL.rnnt_alphas(blank, emit, f_len, y_len)
        rb_g = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -k_loss)
        check(all(torch.equal(x, y) for x, y in zip((*rb, *rb_g), (alphas, k_loss, *grads))),
              "[t-long-eval] the read-back route differs")
        ms["readback"] = graph_ms(lambda: RL.rnnt_alphas(blank, emit, f_len, y_len), 5, 3)
        ms["readback_bwd"] = graph_ms(
            lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -k_loss), 5, 3)
    say("t-long-eval", config="EfficientConformerTransducerSmall", seconds=T_LONG_SECONDS,
        B=b, T=t, U1=u1, threads=threads, strip=strip_width, ring=ring, smem_bytes=smem,
        loss=f"{float(loss):.4f}", rnnt_fwd_launches=fwd, strip_launches=strip,
        rnnt_bwd_launches=bwd, relpos_launches=f"{rel_fwd}/{rel_bwd}", bias_launches=bias,
        **fields, eval_ms=f"{ms['eval']:.1f}", encoder_ms=f"{ms['encoder']:.1f}",
        loss_ms=f"{ms['loss']:.1f}", kernel_ms=f"{ms['kernel']:.4f}",
        kernel_bwd_ms=f"{ms['kernel_bwd']:.4f}",
        readback_ms=f"{ms['readback']:.4f}/{ms['readback_bwd']:.4f}",
        kernel_bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
        us_per_diagonal=f"{1e3 * ms['kernel'] / (t + u1 - 1):.3f}",
        encoder_share=f"{ms['encoder'] / ms['eval']:.3f}",
        loss_share=f"{ms['loss'] / ms['eval']:.3f}",
        kernel_share=f"{ms['kernel'] / ms['eval']:.4f}",
        peak_mem_gib=f"{peak / 2**30:.2f}", card=f"'{card_line}'")
    del trainer, seen, blank, emit, alphas, grads
    torch.cuda.empty_cache()
    return strip, e_f, e_b, ms


def t_batch_labels(n, u_max, seed):
    """Random labels in [1, 1000) for n utterances, u_max and shorter."""
    rng = np.random.default_rng(seed)
    y_len = np.linspace(u_max, u_max // 3, n).astype(np.int64)
    y = rng.integers(1, 1000, (n, u_max))
    y[np.arange(u_max)[None] >= y_len[:, None]] = 0
    return torch.from_numpy(y), torch.from_numpy(y_len)


def t_encoder_params() -> dict:
    from efficientconformer_torch.config import load_config

    return load_config(T_CONFIG)["encoder_params"]


def phase_t_requests():
    from efficientconformer_torch.config import encoder_output_frames
    from efficientconformer_torch.models import transducer as T

    t_enc = t_encoder_params()
    model = make_transducer("cuda", torch.bfloat16)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    cap = T.greedy_token_cap(t_enc, x.shape[1], MAX_CONSEC)
    reset_rel_counts()
    tokens, counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    n_att = len(model.encoder.blocks)
    check(launches == n_att and tc == n_att, f"{launches} kernel launches for one encode, "
          f"{tc} on the tensor cores, expected {n_att} each")
    frame_tokens, frame_counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC, algo="frame")
    check(torch.equal(tokens, frame_tokens) and torch.equal(counts, frame_counts),
          f"label loop {counts.tolist()} != frame loop {frame_counts.tolist()}")
    frames = [encoder_output_frames(t_enc, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    counts = counts.tolist()
    check(all(0 < c <= MAX_CONSEC * f for c, f in zip(counts, frames)), f"counts {counts}")
    check(tokens.shape == (len(REQUEST_SECONDS), cap), f"tokens {tuple(tokens.shape)}")
    say("t-requests", seconds=list(REQUEST_SECONDS), frames=frames, tokens=counts, cap=cap,
        launches=launches, tc_launches=tc, frame_loop="equal")
    return launches, tc


def phase_t_slice():
    from efficientconformer_torch.models import transducer as T

    model = make_transducer("cuda", torch.float32)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    y, y_len = t_batch_labels(len(REQUEST_SECONDS), 30, SEED)
    y = y.cuda()
    reset_rel_counts()
    with torch.inference_mode():
        logits_k, len_k = model(x, y, x_len, y_len.cuda())
        torch.cuda.synchronize()
        counts = rel_counts()[:2]
        check(counts == (len(model.encoder.blocks), 0), f"fp32 launches {counts}, expected "
              "every one on the FMA route")
        with plain_kernels():
            logits_p, len_p = model(x, y, x_len, y_len.cuda())
    check(torch.equal(len_k, len_p), f"lengths {len_k.tolist()} / {len_p.tolist()}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite lattice logits")
    valid = torch.arange(logits_k.shape[1], device="cuda")[None, :] < len_k[:, None]
    err = (logits_k - logits_p).abs()[valid].max().item()
    check(err <= SLICE_TOL, f"kernel vs plain lattice |diff| {err} > {SLICE_TOL}")
    cpu_model = make_transducer("cpu", torch.float32)
    with torch.inference_mode():
        logits_c, _ = cpu_model(x.cpu(), y.cpu(), x_len.cpu(), y_len)
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU lattice |diff| {err_cpu} > {SLICE_TOL}")
    agree = (logits_k.cpu().argmax(-1) == logits_c.argmax(-1))[valid.cpu()].float().mean().item()
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"card vs CPU argmax agreement {agree}")

    cap = T.greedy_token_cap(t_encoder_params(), x.shape[1], MAX_CONSEC)
    tok_k, n_k = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    with plain_kernels():
        tok_p, n_p = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    check(torch.equal(tok_k, tok_p) and torch.equal(n_k, n_p),
          f"greedy tokens kernel {n_k.tolist()} vs plain {n_p.tolist()}")
    say("t-slice", dtype="float32", lattice=tuple(logits_k.shape), max_abs_diff=f"{err:.3g}",
        cpu_max_abs_diff=f"{err_cpu:.3g}", cpu_argmax_agreement=f"{agree:.6f}",
        greedy_tokens=n_k.tolist(), greedy_kernel_vs_plain="equal", route="fma")


def phase_t_rate(card_line: str):
    from efficientconformer_torch.models import transducer as T

    model = make_transducer("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((T_RATE_BATCH, n)) * 0.1).astype(np.float32)).cuda()
    x_len = torch.full((T_RATE_BATCH,), n, device="cuda")
    cap = T.greedy_token_cap(t_encoder_params(), n, MAX_CONSEC)
    reset_rel_counts()
    T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    check(launches == tc == len(model.encoder.blocks),
          f"rel-pos launches {launches}, {tc} on the tensor cores, for one batch")
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(bool((counts > 0).all()), "an utterance decoded to no token")
    say("t-rate", batch=T_RATE_BATCH, seconds=TIME_SECONDS, dtype="bfloat16", algo="label",
        ms_per_batch=f"{dt * 1e3:.2f}", audio_s_per_s=f"{T_RATE_BATCH * TIME_SECONDS / dt:.1f}",
        tokens_per_utt=f"{counts.float().mean().item():.1f}", token_cap=cap,
        loop_iterations=int(counts.max()) + 1,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=launches,
        tc_launches=tc, card=f"'{card_line}'")


def launch_counts():
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    return (RL.rnnt_alphas.launches, RL.rnnt_grads.launches, RA.relpos_attention.launches,
            RA.relpos_attention_bwd.launches)


def reset_launch_counts():
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rnnt_loss as RL

    RL.rnnt_alphas.launches = RL.rnnt_grads.launches = 0
    reset_rel_counts()
    BA.bias_attention.launches = BA.bias_attention_bwd.launches = 0
    BA.bias_attention.tc_launches = BA.bias_attention_bwd.tc_launches = 0
    BA.bias_attention.routes.clear()
    BA.bias_attention_bwd.routes.clear()


def bias_tc_counts():
    """Of the bias launches, those of the tensor-core route (bf16):
    (forward, backward)."""
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.bias_attention.tc_launches, BA.bias_attention_bwd.tc_launches


def bias_launch_counts():
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.bias_attention.launches, BA.bias_attention_bwd.launches


def phase_t_train_slice():
    cfg = train_config(T_CONFIG, mixed_precision=False, vn_start_step=None)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    labels = [[12, 30, 10, 20], [25, 10, 18, 30]]
    batch = train_batch(2, 4, seconds, labels, "cpu", np.random.default_rng(SEED + 7))
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_att = cfg["encoder_params"]["num_blocks"] * 2
    check(counts == (2, 4, n_att, n_att), f"launches (RNN-T fwd, bwd, rel-pos fwd, bwd) "
          f"{counts}, expected (2, 4, {n_att}, {n_att}) for 2 microbatches (the RNN-T "
          f"backward: two kernels a call)")
    check(rel_counts()[1::2] == (0, 0), f"fp32 step: tensor-core launches {rel_counts()}")
    out = compare_steps(kernel, cfg, batch)
    say("t-train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        launches=counts, route="fma", **out)


def phase_t_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(T_CONFIG, lr_schedule="Constant", lr_value=1e-3)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(1, 8, 4.0, [10, 14, 18, 12, 16, 8, 20, 11], "cuda",
                        np.random.default_rng(SEED + 8))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("t-train-learns", steps=LEARN_STEPS, batch="8x4s", first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", min_loss=f"{min(losses):.4f}")


def t_rate_trainer():
    """The Transducer config's own training step (bf16, dropout 0.1,
    SpecAugment, Adam + Transformer schedule) and its batch: 4 microbatches
    of 16 x 16 s with labels of 90 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(T_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(tp["accumulated_steps"], tp["batch_size"],
                        tp["train_audio_max_length"] / SAMPLE_RATE,
                        [tp["train_label_max_length"]], "cuda", np.random.default_rng(SEED + 9))
    return trainer, batch


def phase_t_train_rate(card_line: str):
    trainer, batch = t_rate_trainer()
    accum, b, t = batch["audio"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_att = trainer.config["encoder_params"]["num_blocks"] * accum
    check(counts == (accum, 2 * accum, n_att, n_att), f"launches (RNN-T fwd, bwd, rel-pos "
          f"fwd, bwd) {counts} in one step, expected ({accum}, {2 * accum}, {n_att}, {n_att}) "
          f"(the RNN-T backward: two kernels a call)")
    tc = rel_counts()[1::2]
    check(tc == (n_att, n_att), f"rel-pos tensor-core launches {tc}, expected every launch")
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one step with the config's variational noise on (from vn_start_step)
    trainer.step = trainer.vn_start_step
    t0 = time.perf_counter()
    loss_vn, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt_vn = time.perf_counter() - t0
    check(math.isfinite(float(loss_vn)), f"VN step loss {float(loss_vn)}")
    audio_s = accum * b * t / SAMPLE_RATE
    say("t-train-rate", microbatches=accum, batch=b, seconds=t / SAMPLE_RATE,
        labels=batch["labels"].shape[-1], dtype="bfloat16", ms_per_step=f"{dt * 1e3:.2f}",
        audio_s_per_s=f"{audio_s / dt:.1f}", peak_mem_gib=f"{peak:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}",
        launches=counts, tc_launches=tc, vn_step_ms=f"{dt_vn * 1e3:.2f}",
        vn_loss=f"{float(loss_vn):.4f}", card=f"'{card_line}'")
    return counts + tc


# ---------------------------------------------------------------- LM-Transformer


def lm_params() -> dict:
    from efficientconformer_torch.config import load_config

    return load_config(LM_CONFIG)["lm_params"]


def bias_inputs(b, h, nq, nk, dqk, dv, layout, gen, masked_row=False):
    """(q, k, v, bias, scale) on the card. q, k, v are head-split views of
    (B, N, H, d) projections, as the attention module passes them. The
    bias: "causal", the LM's (B, H, N, N) rel-pos scores plus its causal and
    ragged padding mask; "batch" (B, 1, Nq, Nk) and "head" (1, H, Nq, Nk)
    broadcasts of such scores; "keymask" (B, 1, 1, Nk). ``masked_row`` masks
    every key of query row 1 of the first (batch, head)."""
    from efficientconformer_torch.ops import masks as M
    from efficientconformer_torch.ops.attention import NEG_INF

    def heads(n, w):
        return torch.randn(b, n, h, w, generator=gen).cuda().transpose(1, 2)

    q, k, v = heads(nq, dqk), heads(nk, dqk), heads(nk, dv)
    lengths = torch.linspace(max(nk // 3, 1), nk, b).round().long()
    shape = {"causal": (b, h, nq, nk), "batch": (b, 1, nq, nk), "head": (1, h, nq, nk),
             "keymask": (b, 1, 1, nk)}[layout]
    bias = torch.randn(shape, generator=gen) if layout != "keymask" else torch.zeros(shape)
    if layout == "causal":
        bias = bias + M.look_ahead_mask(nq, lengths) * NEG_INF
    elif layout != "head":
        bias = bias + M.padding_mask(nk, lengths) * NEG_INF
    if masked_row:
        bias[0, 0, 1] = NEG_INF
    return q, k, v, bias.cuda(), 1.0 / math.sqrt(dqk)


def bias_grad_errors(got, want):
    """max |diff| / max(max|want|, 1) of dq, dk, dv and dS."""
    return {n: (g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1.0)
            for n, g, w in zip(("dq", "dk", "dv", "ds"), got, want)}


def check_bias_case(name, args, gen, phase="lm-kernel"):
    """Both bias kernels vs their plain versions on ``args``: fp32 (O, LSE;
    the four gradients on the same dO), then bf16 on bf16-rounded q, k, v
    (the plain versions compute in fp32 from the same bf16 inputs, so the
    difference is the kernels' bf16 outputs, 8 mantissa bits, plus the fp32
    order; the JAX package's XLA route also rounds P to bf16 before P V,
    which neither does). The largest fp32 errors, forward and backward."""
    from efficientconformer_torch.ops import bias_attention as BA

    q, k, v, bias, scale = args
    reset_launch_counts()
    o, lse = BA.bias_attention_fwd(*args)
    want_o, want_lse = BA.reference_bias_attention(*args)
    do = torch.randn(o.shape, generator=gen).cuda()
    got = BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale)
    want = BA.reference_bias_attention_bwd(q, k, v, bias, do, scale)
    torch.cuda.synchronize()
    err_o = (o - want_o).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    check(err_o <= KERNEL_FP32_TOL and err_lse <= KERNEL_FP32_TOL,
          f"{name} fp32: |O| {err_o} |LSE| {err_lse} > {KERNEL_FP32_TOL}")
    err = bias_grad_errors(got, want)
    check(max(err.values()) <= GRAD_TOL, f"{name} fp32 backward: {err} > {GRAD_TOL}")
    check(bias_tc_counts() == (0, 0), f"{name} fp32 went through the tensor-core kernels")

    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    o16, lse16 = BA.bias_attention_fwd(q16, k16, v16, bias, scale)
    want16, _ = BA.reference_bias_attention(q16, k16, v16, bias, scale)
    err16 = (o16.float() - want16.float()).abs().max().item()
    check(o16.dtype == torch.bfloat16 and err16 <= KERNEL_BF16_TOL,
          f"{name} bf16: |O| {err16} > {KERNEL_BF16_TOL}")
    got16 = BA.bias_attention_bwd(q16, k16, v16, bias, o16, do.bfloat16(), lse16, scale)
    want16 = BA.reference_bias_attention_bwd(q16, k16, v16, bias, do.bfloat16(), scale)
    err16b = bias_grad_errors(got16, want16)
    check(got16[0].dtype == torch.bfloat16 and max(err16b.values()) <= GRAD_BF16_TOL,
          f"{name} bf16 backward: {err16b} > {GRAD_BF16_TOL}")
    check(bias_launch_counts() == (2, 2) and bias_tc_counts() == (1, 1),
          f"{name}: launches {bias_launch_counts()}, tensor-core {bias_tc_counts()}, "
          "expected the bf16 pair on the tensor cores")
    say(phase, case=name, B=q.shape[0], H=q.shape[1], Nq=q.shape[2], Nk=k.shape[2],
        dqk=q.shape[3], dv=v.shape[3],
        bias=tuple(bias.shape) if bias is not None else None, fp32_err_o=f"{err_o:.3g}",
        fp32_err_lse=f"{err_lse:.3g}", fp32_bwd_rel_err=f"{max(err.values()):.3g}",
        bf16_err_o=f"{err16:.3g}", bf16_bwd_rel_err=f"{max(err16b.values()):.3g}")
    return max(err_o, err_lse), max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(got, want))


def bias_cost(b, h, nq, nk, dqk, dv, itemsize, backward):
    """(FLOPs, bytes) of the bias attention: the dense products (forward
    q k^T and P V; backward the scores again, dP, dv, dq and dk) and each
    input read once and each output written once: q, k, v, O (and dO, dq,
    dk, dv) in the input type, the bias and dS in fp32, the LSE in fp64."""
    qk, ov = b * h * nq * dqk * itemsize, b * h * nq * dv * itemsize
    kk, vv = b * h * nk * dqk * itemsize, b * h * nk * dv * itemsize
    scores, lse = b * h * nq * nk * 4, b * h * nq * 8
    if backward:
        return (2 * b * h * nq * nk * (3 * dqk + 2 * dv),
                qk + kk + vv + 2 * ov + scores + lse + qk + kk + vv + scores)
    return 2 * b * h * nq * nk * (dqk + dv), qk + kk + vv + scores + ov + lse


def phase_lm_kernel():
    """Both bias kernels checked on the LM's shapes and the other bias
    layouts, then timed at the LM's training shape (B 64, bf16), beside the
    plain versions, the bound and scaled_dot_product_attention with the same
    bias as attn_mask (in bf16, the type it takes; forward + backward with
    the mask requiring a gradient, as the LM's bias does). Each is timed
    from a CUDA graph (device time, graph_ms: the kernels' ms) and from
    back-to-back eager calls (cuda_ms: *_call_ms, the host's time per call
    included)."""
    from efficientconformer_torch.ops import bias_attention as BA

    p = lm_params()
    h, dh, n = p["num_heads"], p["dim_model"] // p["num_heads"], 101
    gen = torch.Generator().manual_seed(SEED + 10)
    err_f = err_b = 0.0
    for name, b, hh, nq, dqk, dv, layout, masked in (
            ("lm-causal", LM_CHECK_BATCH, h, n, dh, dh, "causal", False),
            ("batch-bias", LM_CHECK_BATCH, h, n, dh, dh, "batch", False),
            ("head-bias", LM_CHECK_BATCH, h, n, dh, dh, "head", False),
            ("keymask", LM_CHECK_BATCH, h, n, dh, dh, "keymask", False),
            ("dqk90-dv70", 4, 4, 130, 90, 70, "causal", False),
            ("masked-row", LM_CHECK_BATCH, h, n, dh, dh, "causal", True)):
        args = bias_inputs(b, hh, nq, nq, dqk, dv, layout, gen, masked)
        ef, eb = check_bias_case(name, args, gen)
        err_f, err_b = max(err_f, ef), max(err_b, eb)

    q, k, v, bias, scale = bias_inputs(LM_TIME_BATCH, h, n, n, dh, dh, "causal", gen)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
    do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
    mask16 = bias.to(torch.bfloat16)
    lq, lk, lv, lmask = (t.detach().clone().requires_grad_() for t in (q, k, v, mask16))

    def library_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask, scale=scale)
        return torch.autograd.grad(out, (lq, lk, lv, lmask), do)

    check(library_bwd()[3] is not None, "scaled_dot_product_attention gave the mask no gradient")
    calls = {"forward": {
        "kernel": lambda: BA.bias_attention_fwd(q, k, v, bias, scale),
        "plain": lambda: BA.reference_bias_attention(q, k, v, bias, scale),
        "library": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask16,
                                                          scale=scale)}, "backward": {
        "kernel": lambda: BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale),
        "plain": lambda: BA.reference_bias_attention_bwd(q, k, v, bias, do, scale),
        "library": library_bwd}}
    rows = {}
    for label, fns in calls.items():
        backward = label == "backward"
        row = {name: graph_ms(fn) for name, fn in fns.items()}
        per_call = {f"{name}_call": cuda_ms(fn) for name, fn in fns.items()}
        row["bound"], row["bound_by"] = bound(*bias_cost(LM_TIME_BATCH, h, n, n, dh, dh, 2,
                                                         backward))
        say("lm-kernel-time", direction=label, B=LM_TIME_BATCH, H=h, N=n, dh=dh,
            dtype="bfloat16", bound_by=row["bound_by"],
            library="sdpa fwd" if not backward else "sdpa fwd+bwd, mask grad",
            **{f"{k}_ms": f"{v:.4f}" for k, v in {**row, **per_call}.items() if k != "bound_by"})
        rows[label] = row
    return err_f, rows["forward"], err_b, rows["backward"]


def make_lm(device, dtype):
    """The LM-Transformer at full width and depth, weights from SEED, with
    non-trivial LayerNorm parameters."""
    from efficientconformer_torch.models.lm import build_model

    return perturb_norms_(build_model(LM_CONFIG, device, dtype,
                                      torch.Generator().manual_seed(SEED)))


def lm_batch(accum, batch, lengths, device, rng):
    """Stacked LM microbatches (accum, batch, ...): random tokens in [1, V)
    of the given lengths, 0 past them; targets the tokens, then 0, then -1
    (data/loader.py:223-229)."""
    vocab = lm_params()["vocab_size"]
    n = np.broadcast_to(np.asarray(lengths, dtype=np.int64), (accum, batch)).copy()
    u = int(n.max())
    tokens = rng.integers(1, vocab, (accum, batch, u))
    past = np.arange(u)[None, None, :] >= n[..., None]
    tokens[past] = 0
    targets = np.full((accum, batch, u + 1), -1, np.int64)
    targets[..., :u] = np.where(past, -1, tokens)
    np.put_along_axis(targets, n[..., None], 0, axis=-1)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "token_len": torch.from_numpy(n).to(device),
            "targets": torch.from_numpy(targets).to(device)}


def phase_lm_slice():
    from efficientconformer_torch.ops import bias_attention as BA

    model = make_lm("cuda", torch.float32)
    lengths = np.linspace(*LM_SLICE_LENGTHS, LM_CHECK_BATCH).round().astype(np.int64)
    mb = {k: v[0] for k, v in lm_batch(1, LM_CHECK_BATCH, lengths, "cuda",
                                        np.random.default_rng(SEED)).items()}
    reset_launch_counts()
    with torch.inference_mode():
        logits_k = model(mb["tokens"], mb["token_len"])
        torch.cuda.synchronize()
        launches, tc = BA.bias_attention.launches, BA.bias_attention.tc_launches
        with plain_kernels():
            logits_p = model(mb["tokens"], mb["token_len"])
    n_blocks = lm_params()["num_blocks"]
    check(launches == n_blocks and tc == 0, f"{launches} bias kernel launches for one "
          f"forward, {tc} of them on the tensor cores, expected {n_blocks} on the FMA route")
    check(bool(torch.isfinite(logits_k).all()), "non-finite LM logits")
    valid = (torch.arange(logits_k.shape[1], device="cuda")[None, :]
             <= mb["token_len"][:, None])
    err = (logits_k - logits_p).abs()[valid].max().item()
    check(err <= SLICE_TOL, f"kernel vs plain LM logits |diff| {err} > {SLICE_TOL}")
    cpu_model = make_lm("cpu", torch.float32)
    with torch.inference_mode():
        logits_c = cpu_model(mb["tokens"].cpu(), mb["token_len"].cpu())
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    agree = (logits_k.cpu().argmax(-1) == logits_c.argmax(-1))[valid.cpu()].float().mean().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU LM logits |diff| {err_cpu} > {SLICE_TOL}")
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"card vs CPU argmax agreement {agree}")
    say("lm-slice", dtype="float32", logits=tuple(logits_k.shape), lengths=lengths.tolist(),
        max_abs_diff=f"{err:.3g}", cpu_max_abs_diff=f"{err_cpu:.3g}",
        cpu_argmax_agreement=f"{agree:.6f}", launches=launches, route="fma")


def lm_score_setup():
    """The LM config's trainer (bf16, its mixed_precision) and one scoring
    batch of 64 full-length sequences (100 tokens + the blank)."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(LM_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = lm_batch(1, LM_TIME_BATCH, [tp["train_label_max_length"]], "cuda",
                     np.random.default_rng(SEED + 11))
    return trainer, {k: v[0] for k, v in batch.items()}


def phase_lm_score_rate(card_line: str):
    trainer, mb = lm_score_setup()
    for _ in range(2):
        trainer.eval_loss(mb)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss = trainer.eval_loss(mb)
    torch.cuda.synchronize()
    fwd, bwd = bias_launch_counts()
    tc = bias_tc_counts()
    n_blocks = lm_params()["num_blocks"]
    check((fwd, bwd) == (n_blocks, 0), f"bias launches {fwd}/{bwd} for one scoring batch, "
          f"expected {n_blocks}/0")
    check(tc == (n_blocks, 0), f"tensor-core launches {tc}, expected every bias launch")
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = trainer.eval_loss(mb)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    tokens = int((mb["token_len"] + 1).sum())
    check(math.isfinite(float(loss)), f"eval loss {float(loss)}")
    say("lm-score-rate", batch=LM_TIME_BATCH, positions=mb["targets"].shape[-1],
        dtype="bfloat16", ms_per_batch=f"{dt * 1e3:.3f}", tokens_per_s=f"{tokens / dt:.1f}",
        eval_loss=f"{float(loss):.4f}", perplexity=f"{math.exp(min(float(loss), 30.0)):.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=fwd,
        tc_launches=tc[0], card=f"'{card_line}'")
    return fwd


def phase_lm_train_slice():
    cfg = train_config(LM_CONFIG, mixed_precision=False)
    cfg["lm_params"]["Pdrop"] = 0.0
    lengths = [[20, 55, 100, 10], [70, 35, 90, 45]]
    batch = lm_batch(2, 4, lengths, "cpu", np.random.default_rng(SEED + 12))
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    counts = bias_launch_counts()
    n_att = cfg["lm_params"]["num_blocks"] * 2
    check(counts == (n_att, n_att), f"bias launches (fwd, bwd) {counts}, expected "
          f"({n_att}, {n_att}) for 2 microbatches")
    check(bias_tc_counts() == (0, 0), f"fp32 step: tensor-core launches {bias_tc_counts()}")
    out = compare_steps(kernel, cfg, batch)
    say("lm-train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        launches=counts, route="fma", **out)


def phase_lm_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    lr = train_config(LM_CONFIG)["training_params"]["lr_max"]
    cfg = train_config(LM_CONFIG, lr_schedule="Constant", lr_value=lr)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    lengths = np.linspace(20, 60, 8).round().astype(np.int64)
    batch = lm_batch(1, 8, lengths, "cuda", np.random.default_rng(SEED + 13))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("lm-train-learns", steps=LEARN_STEPS, batch="8x20-60", lr=lr,
        first_loss=f"{losses[0]:.4f}", last_loss=f"{losses[-1]:.4f}",
        min_loss=f"{min(losses):.4f}")


def lm_rate_trainer():
    """The LM config's own training step (bf16, dropout 0.1, Adam with betas
    0.9/0.95 under the Cosine schedule) and its batch: 5 microbatches of 64
    sequences of 100 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(LM_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = lm_batch(tp["accumulated_steps"], tp["batch_size"], [tp["train_label_max_length"]],
                     "cuda", np.random.default_rng(SEED + 14))
    return trainer, batch


def lm_step_flops(trainer, batch) -> float:
    """Model FLOPs of one step: 6 per parameter per token for the matrix
    products, plus the attention's (B, H, T, T) products (q k^T, P V and the
    rel-pos scores qv e^T), three times for forward and backward."""
    p = trainer.config["lm_params"]
    accum, b, u = batch["tokens"].shape
    t, d = u + 1, p["dim_model"]
    n_params = sum(x.numel() for x in trainer.model.parameters())
    attention = 3 * p["num_blocks"] * accum * 2 * b * t * t * d * 3
    return 6 * n_params * accum * b * t + attention


def phase_lm_train_rate(card_line: str):
    trainer, batch = lm_rate_trainer()
    accum, b, u = batch["tokens"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    counts = bias_launch_counts()
    tc = bias_tc_counts()
    n_att = trainer.config["lm_params"]["num_blocks"] * accum
    check(counts == (n_att, n_att), f"bias launches (fwd, bwd) {counts} in one step, "
          f"expected ({n_att}, {n_att})")
    check(tc == counts, f"tensor-core launches {tc}, expected every bias launch {counts}")
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    tokens = accum * b * (u + 1)
    flops = lm_step_flops(trainer, batch)
    say("lm-train-rate", microbatches=accum, batch=b, positions=u + 1, dtype="bfloat16",
        ms_per_step=f"{dt * 1e3:.2f}", tokens_per_s=f"{tokens / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}", launches=counts,
        tc_launches=tc, model_tflop=f"{flops / 1e12:.2f}",
        bf16_peak_share=f"{flops / dt / BF16_PEAK:.4f}",
        card=f"'{card_line}'")
    return counts


# ---------------------------------------------------------------- the CLI


class Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


# every kernel's launches (all_counts' order) summed over the run_cli calls
# since phase_cli began: only the CLI's own launches
CLI_LAUNCHES = [0] * 10


def run_cli(*args) -> str:
    """``python -m efficientconformer_torch.main *args`` in this process;
    its standard output, which is printed as well. The kernel counters are
    set to 0 just before the run and read just after, into CLI_LAUNCHES."""
    from efficientconformer_torch.main import main as cli_main

    buf = io.StringIO()
    reset_launch_counts()
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
            rc = cli_main([str(a) for a in args])
    finally:
        for i, n in enumerate(all_counts()):
            CLI_LAUNCHES[i] += n
    check(rc == 0, f"the CLI returned {rc} for {args}")
    return buf.getvalue()


def all_counts() -> tuple:
    """Every kernel counter: rel-pos fwd, fwd on the tensor cores, bwd, bwd
    on the tensor cores, RNN-T fwd, bwd, bias fwd, fwd on the tensor cores,
    bwd, bwd on the tensor cores."""
    return rel_counts() + launch_counts()[:2] + tuple(
        x for pair in zip(bias_launch_counts(), bias_tc_counts()) for x in pair)


@contextlib.contextmanager
def spied_trainer(profile=False):
    """Records each ``Trainer.train_step`` call made inside: the kernel
    launches it made (the counters' increase over the call, so
    validation's launches fall outside), its batch's shape, its loss and,
    with ``profile``, its device ms (the step under the profiler, then
    synchronized: its wall clock no longer counts); and each
    ``Trainer.save``: a copy of what was saved. Yields (steps, saves)."""
    import copy

    from efficientconformer_torch.training.trainer import Trainer

    steps, saves = [], {}
    train_step, save = Trainer.train_step, Trainer.save

    def spy_step(self, batch, *args, **kw):
        before = all_counts()
        outs = []
        ms = (device_ms(lambda: outs.append(train_step(self, batch, *args, **kw)), 1)[0]
              if profile else outs.append(train_step(self, batch, *args, **kw)))
        steps.append({"launches": tuple(a - b for a, b in zip(all_counts(), before)),
                      "shape": tuple((batch.get("audio", batch.get("tokens"))).shape),
                      "loss": outs[0][0], "device_ms": ms})
        return outs[0]

    def spy_save(self, path, save_optimizer=True):
        save(self, path, save_optimizer)
        saves[path] = {"model": {k: v.detach().clone() for k, v in
                                 self.model.state_dict().items()},
                       "optimizer": copy.deepcopy(self.optimizer.state_dict()),
                       "step": self.step}

    with mock.patch.object(Trainer, "train_step", spy_step), \
            mock.patch.object(Trainer, "save", spy_save):
        yield steps, saves


def same_state(got, want) -> bool:
    """Bitwise equality of nested dicts, lists and tensors."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(same_state(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(same_state(g, w) for g, w in zip(got, want))
    if torch.is_tensor(want):
        return (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got.to(want.device), want))
    return got == want


def lexicon(rng, n_words=4000):
    """Made-up words of 1-4 consonant-vowel syllables, distinct, seeded."""
    syllables = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(syllables, rng.integers(1, 5))))
    return sorted(words)


def sentence(rng, words, n) -> str:
    """``n`` words drawn with Zipf-like frequencies."""
    return " ".join(words[(int(rng.zipf(1.2)) - 1) % len(words)] for _ in range(n))


def load_flac_encoder():
    """tests/flac_encoder.py (numpy only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("flac_encoder", "tests/flac_encoder.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_librispeech(root, rng, words) -> dict:
    """A LibriSpeech-layout tree of seeded noise: split/speaker/chapter/
    {utt}.wav|.flac and {speaker}-{chapter}.trans.txt, about 2.2 words a
    second; the first utterance of each split as FLAC. The int16 samples of
    the FLAC files, by path."""
    import wave

    encoder = load_flac_encoder()
    flacs = {}
    for split, (n, lo, hi) in CLI_SPLITS.items():
        for i in range(n):
            spk, chap = 100 + i // 32, 1
            d = os.path.join(root, split, str(spk), str(chap))
            os.makedirs(d, exist_ok=True)
            utt = f"{spk}-{chap}-{i:04d}"
            samples = int(rng.uniform(lo, hi) * SAMPLE_RATE)
            x = (rng.standard_normal(samples) * 0.05 * 32767).astype(np.int16)
            if i == 0:
                path = os.path.join(d, utt + ".flac")
                with open(path, "wb") as f:
                    f.write(encoder.encode_flac(x[None].astype(np.int64), blocksize=4096))
                flacs[path] = x
            else:
                with wave.open(os.path.join(d, utt + ".wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(SAMPLE_RATE)
                    w.writeframes(x.tobytes())
            text = sentence(rng, words, max(3, round(samples / SAMPLE_RATE * 2.2))).upper()
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "a") as f:
                f.write(f"{utt} {text}\n")
    return flacs


def cli_config(path, tmp, name, epochs, **paths) -> str:
    """``path``'s config with its dataset, tokenizer and callback paths
    under ``tmp`` and its epochs set; everything else its own. The new
    config's path."""
    from efficientconformer_torch.config import load_config

    cfg = load_config(path)
    tp = cfg["training_params"]
    root = os.path.join(tmp, "LibriSpeech") + "/"
    cfg["tokenizer_params"]["tokenizer_path"] = os.path.join(
        root, os.path.basename(cfg["tokenizer_params"]["tokenizer_path"]))
    tp.update(training_dataset_path=root, evaluation_dataset_path=root,
              callback_path=os.path.join(tmp, "callbacks", name) + "/", epochs=epochs, **paths)
    out = os.path.join(tmp, f"{name}.json")
    with open(out, "w") as f:
        json.dump(cfg, f)
    return out


def epoch_lines(out) -> list:
    """(epoch, mean loss, steps, ms a step) of each epoch line the CLI printed."""
    return [(int(e), float(x), int(n), float(ms)) for e, x, n, ms in re.findall(
        r"epoch (\d+)/\d+ loss (\S+) \([\d.]+s, (\d+) steps, ([\d.]+) ms/step\)", out)]


def phase_cli_data(tmp):
    """The synthetic LibriSpeech tree and the LM corpus; the native FLAC
    decoder on it."""
    from efficientconformer_torch.data import audio_io

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    words = lexicon(rng)
    flacs = write_librispeech(os.path.join(tmp, "LibriSpeech"), rng, words)
    corpus = os.path.join(tmp, "librispeech-lm-norm.txt")
    with open(corpus, "w") as f:
        for _ in range(CLI_LM_LINES):
            f.write(sentence(rng, words, int(rng.integers(5, 40))).upper() + "\n")
    write_s = time.perf_counter() - t0
    check(audio_io.flac_backend() == "native", f"FLAC backend {audio_io.flac_backend()}")
    for path, x in flacs.items():
        got, sr = audio_io.load_audio(path)
        check(sr == SAMPLE_RATE and np.array_equal(got, x.astype(np.float32) / 32768.0),
              f"{path}: the native decoder's samples differ from those encoded")
    sizes = {split: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                        os.walk(os.path.join(tmp, "LibriSpeech", split)) for f in fs)
             for split in CLI_SPLITS}
    say("cli-data", bytes=sizes, lm_corpus_bytes=os.path.getsize(corpus),
        flac_files=len(flacs), flac_backend="native", write_s=f"{write_s:.2f}")


@contextlib.contextmanager
def native_bpe_spy():
    """Counts the tokenizer trainings of data/preparation.py by route:
    yields {"native": trainings that returned a tokenizer, "python": the
    pure-Python fallback's}."""
    from efficientconformer_torch.data import preparation

    calls = {"native": 0, "python": 0}
    native, python = preparation.train_bpe_native, preparation.train_bpe

    def spy_native(*args, **kw):
        tok = native(*args, **kw)
        calls["native"] += tok is not None
        return tok

    def spy_python(*args, **kw):
        calls["python"] += 1
        return python(*args, **kw)

    with mock.patch.object(preparation, "train_bpe_native", spy_native), \
            mock.patch.object(preparation, "train_bpe", spy_python):
        yield calls


def check_steps(phase, steps, want, n):
    """``n`` steps, each with the launches ``want`` (a dict of all_counts
    indices -> count) and a finite loss."""
    check(len(steps) == n, f"{phase}: {len(steps)} training steps, expected {n}")
    for s in steps:
        got = {i: s["launches"][i] for i in want}
        check(got == want, f"{phase}: launches {s['launches']} in a step, expected {want}")
        check(math.isfinite(float(s["loss"])), f"{phase}: loss {float(s['loss'])}")


def phase_cli_train(tmp, card_line, train_rate_ms):
    """CTC Small through the CLI: tokenizer, manifests, 2 epochs of 2 steps
    with validation and a checkpoint each, its ms a step beside
    [train-rate]'s; then the loader alone over the manifests the run wrote,
    its host ms a batch."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.data.datasets import LibriSpeechDataset
    from efficientconformer_torch.data.loader import AsrBatchLoader
    from efficientconformer_torch.ops import rel_factorize as RF

    cfg_path = cli_config(CONFIG, tmp, "ctc", 2)
    cfg = load_config(cfg_path)
    tp, kp = cfg["training_params"], cfg["tokenizer_params"]
    cb = tp["callback_path"]
    tables0, folds0 = RF.rel_tables.cache_info(), RF._fold_tables.cache_info()
    before = tuple(CLI_LAUNCHES)
    t0 = time.perf_counter()
    with spied_trainer() as (steps, saves), native_bpe_spy() as bpe:
        out = run_cli("-c", cfg_path, "-m", "training", "--create_tokenizer", "-p",
                      "--steps_per_epoch", 2, "--val_steps", 1)
    cli_s = time.perf_counter() - t0
    total = tuple(a - b for a, b in zip(CLI_LAUNCHES, before))
    tables, folds = RF.rel_tables.cache_info(), RF._fold_tables.cache_info()
    check(bpe == {"native": 1, "python": 0}, f"tokenizer trainings {bpe}")
    n_att = cfg["encoder_params"]["num_blocks"] * tp["accumulated_steps"]
    check_steps("cli-train", steps, {0: n_att, 1: n_att, 2: n_att, 3: n_att}, 4)
    val_fwd = total[0] - sum(s["launches"][0] for s in steps)
    check(val_fwd > 0 and total[2] == sum(s["launches"][2] for s in steps),
          f"validation launches: {val_fwd} forward, {total[2]} backward in all")
    epochs = epoch_lines(out)
    check([e[:1] + e[2:3] for e in epochs] == [(1, 2), (2, 2)], f"epoch lines {epochs}")
    check(all(math.isfinite(e[1]) for e in epochs), f"epoch losses {epochs}")
    wers = re.findall(r"val: \{'WER': ([\d.]+), 'MeanLoss': ([\d.]+)\}", out)
    check(len(wers) == 2, "the validation WER lines")
    for e in (1, 2):
        check(os.path.exists(os.path.join(cb, f"checkpoints_{e}.ckpt")), f"checkpoints_{e}.ckpt")
    audio_s = int(np.prod(steps[-1]["shape"])) / SAMPLE_RATE

    ds = LibriSpeechDataset(tp["training_dataset_path"], "train", vocab_size=kp["vocab_size"],
                            audio_max_length=tp["train_audio_max_length"],
                            label_max_length=tp["train_label_max_length"])
    loader = AsrBatchLoader(ds, tp["batch_size"], accum_steps=tp["accumulated_steps"],
                            num_workers=CLI_WORKERS)
    t0 = time.perf_counter()
    batches = list(loader.epoch(0))
    load_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    load_audio_s = sum(int(b["audio_len"].sum()) for b in batches) / SAMPLE_RATE / len(batches)
    check(len(batches) >= 2, f"{len(batches)} CTC Small batches in the training split")
    # the second epoch's ms a step: the mean of its 2 steps, its first batch's
    # wait included
    say("cli-train", config="EfficientConformerCTCSmall", seconds=f"{cli_s:.2f}",
        epochs=[(e, f"{x:.4f}", n_) for e, x, n_, _ in epochs],
        val_wer=[float(w) for w, _ in wers], step_launches=steps[0]["launches"][:4],
        val_fwd_launches=val_fwd, cli_ms_per_step=epochs[-1][3],
        cli_audio_s_per_s=f"{audio_s / epochs[-1][3] * 1e3:.1f}",
        train_rate_ms_per_step=f"{train_rate_ms:.2f}",
        rel_tables_misses=tables.misses - tables0.misses, rel_tables_hits=tables.hits - tables0.hits,
        fold_tables_misses=folds.misses - folds0.misses, loader_batches=len(batches),
        loader_shape=tuple(batches[0]["audio"].shape), loader_workers=CLI_WORKERS,
        loader_host_ms_per_batch=f"{load_ms:.1f}",
        loader_audio_s_per_s=f"{load_audio_s / load_ms * 1e3:.1f}", card=f"'{card_line}'")
    return cfg_path, cfg, saves, epochs[-1][3]


def phase_cli_buckets(card_line):
    """The rel-pos table caches over the padded lengths a LibriSpeech epoch
    gives CTC Small: the 8 training buckets of its train_audio_max_length
    and the 8 evaluation buckets of DEV_MAX_SECONDS, a forward at each
    length. An epoch: each training length twice in a seeded order, then
    each evaluation length (validation). Two epochs from empty caches: the
    first epoch's misses fill them, the second's are rebuilds after an
    eviction. And the host ms one miss costs."""
    import random

    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.data.loader import make_buckets
    from efficientconformer_torch.models.model_ctc import greedy_decode
    from efficientconformer_torch.ops import rel_factorize as RF

    train = make_buckets(load_config(CONFIG)["training_params"]["train_audio_max_length"], 8)
    dev = make_buckets(int(DEV_MAX_SECONDS * SAMPLE_RATE), 8)
    model = make_model("cuda", torch.bfloat16).eval()
    rng = random.Random(SEED)
    RF.rel_tables.cache_clear()
    RF._fold_tables.cache_clear()
    misses = []
    with torch.inference_mode():
        for _ in range(2):
            before = RF.rel_tables.cache_info().misses
            order = train * 2
            rng.shuffle(order)
            for n in order + dev:
                greedy_decode(model, torch.zeros(1, n, device="cuda"),
                              torch.tensor([n], device="cuda"))
            misses.append(RF.rel_tables.cache_info().misses - before)
    torch.cuda.synchronize()
    info, folds = RF.rel_tables.cache_info(), RF._fold_tables.cache_info()
    check(misses[0] > 0 and info.hits > 0, f"rel_tables: {info}")
    miss_ms = cuda_ms(lambda: RF.rel_tables.__wrapped__(401, 401, 168, 1, torch.device("cuda")),
                      iters=5, warmup=1)
    say("cli-buckets", config="EfficientConformerCTCSmall",
        train_lengths_s=[e / SAMPLE_RATE for e in train],
        eval_lengths_s=[round(e / SAMPLE_RATE, 3) for e in dev],
        rel_tables_keys=info.currsize, capacity=info.maxsize, misses_epoch_1=misses[0],
        misses_epoch_2=misses[1], fold_tables_misses=folds.misses, miss_ms=f"{miss_ms:.3f}",
        card=f"'{card_line}'")


def phase_cli_resume(cfg_path, cfg, saves, cli_ms):
    """checkpoints_1.ckpt into a fresh trainer, bit for bit what was saved;
    then -i 1 runs epoch 2, each step under the profiler: its device ms,
    and the idle share of [cli-train]'s second epoch (the same batches)."""
    from efficientconformer_torch.training.trainer import Trainer

    cb = cfg["training_params"]["callback_path"]
    path = os.path.join(cb, "checkpoints_1.ckpt")
    trainer = Trainer(cfg, device="cuda", seed=SEED + 1)
    trainer.load(path)
    saved = saves[path]
    check(trainer.step == saved["step"] == 2, f"step {trainer.step} / {saved['step']}")
    check(same_state(trainer.model.state_dict(), saved["model"]),
          "parameters or BatchNorm buffers differ from those saved")
    opt = trainer.optimizer.state_dict()
    check(len(opt["state"]) == len(list(trainer.model.parameters()))
          and same_state(opt, saved["optimizer"]), "Adam state differs from that saved")
    del trainer
    with spied_trainer(profile=True) as (steps, _):
        out = run_cli("-c", cfg_path, "-m", "training", "-i", 1, "--steps_per_epoch", 2,
                      "--val_steps", 1)
    epochs = epoch_lines(out)
    check([e[0] for e in epochs] == [2] and len(steps) == 2, f"resumed epochs {epochs}")
    from efficientconformer_torch.training import checkpoint

    step = checkpoint.read(os.path.join(cb, "checkpoints_2.ckpt"))["step"]
    check(step == 4, f"checkpoints_2.ckpt step {step}")
    busy = [s["device_ms"] for s in steps]
    check(all(ms > 0 for ms in busy), f"device ms of the resumed steps {busy}")
    say("cli-resume", checkpoint="checkpoints_1.ckpt", step=saved["step"],
        tensors=len(saved["model"]), adam_states=len(opt["state"]), bitwise=True,
        resumed_epoch=epochs[0][0], loss=f"{epochs[0][1]:.4f}",
        device_ms_per_step=[f"{ms:.2f}" for ms in busy], cli_ms_per_step=cli_ms,
        idle_share=f"{1 - sum(busy) / len(busy) / cli_ms:.3f}")


def phase_cli_test(cfg_path, cfg):
    """test-clean, greedy: the WER line, and predictions string for string
    those of greedy_decode over the same loader batches."""
    from efficientconformer_torch import runtime
    from efficientconformer_torch.data.datasets import LibriSpeechDataset
    from efficientconformer_torch.data.loader import AsrBatchLoader
    from efficientconformer_torch.models.model_ctc import greedy_decode
    from efficientconformer_torch.training.trainer import Trainer
    from efficientconformer_torch.utils.metrics import wer

    t0 = time.perf_counter()
    out = run_cli("-c", cfg_path, "-m", "test-clean", "-i", 2, "--gready", "--verbose_val")
    cli_s = time.perf_counter() - t0
    printed = [ast.literal_eval(line) for line in
               re.findall(r"Predictions:\n (\[.*\])\n", out)]
    got_wer = float(re.search(r"Greedy Search WER : ([\d.]+)%", out).group(1))
    trainer = Trainer(cfg, device="cuda")
    trainer.load(os.path.join(cfg["training_params"]["callback_path"], "checkpoints_2.ckpt"))
    tok = runtime.load_tokenizer(cfg)
    ds = LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"], "test-clean",
                            vocab_size=cfg["tokenizer_params"]["vocab_size"])
    direct, truths, preds = [], [], []
    for batch in AsrBatchLoader(ds, 8, shuffle=False, drop_last=False).epoch(0):
        audio = torch.from_numpy(batch["audio"][0]).cuda()
        toks, n = greedy_decode(trainer.model.eval(), audio,
                                torch.from_numpy(batch["audio_len"][0]).cuda())
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        strings = tok.decode([toks[b, : n[b]].tolist() for b in range(len(n))])
        direct.append(strings)
        valid = int(batch["n_valid"][0])
        preds += strings[:valid]
        truths += tok.decode([batch["labels"][0, b, : batch["label_len"][0, b]].tolist()
                              for b in range(valid)])
    check(printed == direct, "the CLI's predictions differ from greedy_decode's")
    want_wer = 100 * wer(truths, preds)
    check(f"{got_wer:.2f}" == f"{want_wer:.2f}", f"WER {got_wer} vs {want_wer}")
    say("cli-test", split="test-clean", utterances=len(preds), wer=f"{got_wer:.2f}",
        tokens_per_utt=f"{np.mean([len(tok.encode(p)) for p in preds]):.1f}",
        predictions_equal=True, seconds=f"{cli_s:.2f}")


def phase_cli_dp(tmp):
    """-d through the CLI on the one card: CTC Small over [cli-train]'s
    tokenizer and manifests, one rank over NCCL, one epoch of 2 steps (DDP,
    30 / 30 rel-pos launches a step) with validation and a checkpoint; the
    checkpoint's test-clean WER with -d and without equal; -d with more
    ranks than the visible GPUs refused before any rank starts."""
    import torch.distributed as dist

    from efficientconformer_torch.config import load_config

    cfg_path = cli_config(CONFIG, tmp, "ctc-dp", 1)
    cfg = load_config(cfg_path)
    tp = cfg["training_params"]
    t0 = time.perf_counter()
    with spied_trainer() as (steps, _):
        out = run_cli("-c", cfg_path, "-m", "training", "-d", "--steps_per_epoch", 2,
                      "--val_steps", 1)
    n_att = cfg["encoder_params"]["num_blocks"] * tp["accumulated_steps"]
    check_steps("cli-dp", steps, {0: n_att, 1: n_att, 2: n_att, 3: n_att}, 2)
    epochs = epoch_lines(out)
    check([e[:1] + e[2:3] for e in epochs] == [(1, 2)], f"[cli-dp] epoch lines {epochs}")
    val = re.findall(r"val: \{'WER': ([\d.]+)", out)
    check(len(val) == 1, "[cli-dp] the validation WER line")
    check(os.path.exists(os.path.join(tp["callback_path"], "checkpoints_1.ckpt")),
          "[cli-dp] checkpoints_1.ckpt")
    wers = [float(re.search(r"Greedy Search WER : ([\d.]+)%", run_cli(
        "-c", cfg_path, "-m", "test-clean", "-i", 1, "--gready", *flags)).group(1))
        for flags in (("-d",), ())]
    check(wers[0] == wers[1], f"[cli-dp] test-clean WER with -d {wers[0]}, without {wers[1]}")
    too_many = torch.cuda.device_count() + 1
    try:
        run_cli("-c", cfg_path, "-m", "test-clean", "-i", 1, "--gready", "-d", "--world_size",
                too_many)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "visible" in refusal,
          f"[cli-dp] --world_size {too_many} on {too_many - 1} GPU(s): {refusal}")
    check(not dist.is_initialized(), "[cli-dp] the process group outlived the CLI")
    say("cli-dp", config="EfficientConformerCTCSmall", ranks=1, backend="nccl",
        seconds=f"{time.perf_counter() - t0:.2f}",
        epochs=[(e, f"{x:.4f}", n) for e, x, n, _ in epochs], cli_ms_per_step=epochs[0][3],
        val_wer=float(val[0]), step_launches=steps[0]["launches"][:4], test_wer_dp=wers[0],
        test_wer_one_process=wers[1], refused=f"'{refusal}'")


def phase_cli_swa(cfg_path, cfg):
    """--swa over epochs 1-2: parameters the mean of the two checkpoints,
    BatchNorm statistics refreshed, no optimizer."""
    from efficientconformer_torch.training import checkpoint
    from efficientconformer_torch.training.trainer import Trainer

    cb = cfg["training_params"]["callback_path"]
    t0 = time.perf_counter()
    run_cli("-c", cfg_path, "-m", "training", "--swa", "--swa_epochs", 1, 2,
            "--steps_per_epoch", 2)
    cli_s = time.perf_counter() - t0
    swa = checkpoint.read(os.path.join(cb, "checkpoints_swa-equal-1-2.ckpt"))
    first, last = (checkpoint.read(os.path.join(cb, f"checkpoints_{e}.ckpt")) for e in (1, 2))
    names = {n for n, _ in Trainer(cfg, device="cuda").model.named_parameters()}
    err = max((swa["model"][k] - (first["model"][k] + last["model"][k]) / 2).abs().max().item()
              for k in names)
    stats = [k for k in swa["model"] if "running_" in k]
    refreshed = sum(not torch.equal(swa["model"][k], last["model"][k]) for k in stats)
    check(err <= SWA_TOL, f"SWA parameters {err} from the mean of the checkpoints")
    check(refreshed == len(stats) > 0, f"{refreshed} of {len(stats)} statistics refreshed")
    check(swa["optimizer"] is None and swa["step"] == last["step"], "SWA optimizer or step")
    say("cli-swa", checkpoint="checkpoints_swa-equal-1-2.ckpt", param_err=f"{err:.3g}",
        refreshed_stats=f"{refreshed}/{len(stats)}", optimizer=None, seconds=f"{cli_s:.2f}")


def phase_cli_eval_time(cfg_path):
    times = {}
    for mode in ("eval_time", "eval_time_encoder"):
        out = run_cli("-c", cfg_path, "-m", mode, "-i", 2, "--val_steps", 1)
        times[mode] = float(re.search(r"eval time : ([\d.]+)s", out).group(1))
    say("cli-eval-time", **{k: f"{v:.2f}s" for k, v in times.items()})


def phase_cli_profiler(cfg_path, cfg):
    """eval_time with --profiler: the top-10 table of kernels by device time,
    printed before the eval time, names the rel-pos forward kernel; the
    trace lies under callback_path/profile/."""
    out = run_cli("-c", cfg_path, "-m", "eval_time", "-i", 2, "--val_steps", 1, "--profiler")
    head = re.search(r"profiler: top (\d+) kernels by device time \((.*)\):\n", out)
    check(head is not None, "[profiler] no table")
    table, rest = out[head.end():].split("\neval time : ")
    rows = table.splitlines()[2:]
    relpos = [row.split("  ")[0].strip() for row in rows if "relpos_fwd" in row]
    check(len(rows) == int(head.group(1)) == 10, f"[profiler] {len(rows)} rows")
    check(bool(relpos), f"[profiler] no rel-pos forward kernel among {rows}")
    trace = os.path.join(head.group(2), "trace.json")
    check(head.group(2) == os.path.join(cfg["training_params"]["callback_path"], "profile")
          and os.path.getsize(trace) > 0, f"[profiler] trace {trace}")
    say("profiler", mode="eval_time", rows=len(rows), relpos_rows=relpos,
        top=f"'{rows[0][:60].strip()}'", trace_mib=f"{os.path.getsize(trace) / 2**20:.1f}",
        eval_time=rest.split()[0])


def phase_cli_import(tmp, cfg):
    """An original-style checkpoint of the flagship's seeded weights (with
    the frontend's torchaudio buffers the original saves and a pickled
    sentencepiece processor of [cli-train]'s tokenizer) imported by
    ``python -m efficientconformer_torch.import_checkpoint --with-tokenizer``
    into a fresh callback path; then test-clean -i 9 --gready through the
    CLI: its predictions those of the same weights loaded in-process."""
    import subprocess

    from efficientconformer_torch import runtime
    from efficientconformer_torch.data.datasets import LibriSpeechDataset
    from efficientconformer_torch.data.loader import AsrBatchLoader
    from efficientconformer_torch.models.model_ctc import build_model, greedy_decode
    from efficientconformer_torch.training.trainer import Trainer
    from efficientconformer_torch.utils import spm_shim

    weights = perturb_norms_(build_model(CONFIG, "cpu", torch.float32,
                                         torch.Generator().manual_seed(SEED + 43))).state_dict()
    p = cfg["encoder_params"]
    win = p["sample_rate"] * p["win_length_ms"] // 1000
    original = dict(weights)
    original["encoder.preprocessing.Spectrogram.window"] = torch.hann_window(win)
    original["encoder.preprocessing.MelScale.fb"] = torch.rand(p["n_fft"] // 2 + 1, p["n_mels"])
    proc = spm_shim.install().SentencePieceProcessor(cfg["tokenizer_params"]["tokenizer_path"])
    ckpt = os.path.join(tmp, "original.ckpt")
    torch.save({"model_state_dict": original, "optimizer_state_dict": {}, "model_step": 4321,
                "tokenizer": proc, "is_distributed": False}, ckpt)
    imported = json.loads(json.dumps(cfg))
    imported["tokenizer_params"]["tokenizer_path"] = os.path.join(tmp, "imported", "bpe.model")
    imported["training_params"]["callback_path"] = os.path.join(tmp, "callbacks", "imported") + "/"
    cfg_path = os.path.join(tmp, "imported.json")
    with open(cfg_path, "w") as f:
        json.dump(imported, f)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "efficientconformer_torch.import_checkpoint", "--config_file",
         cfg_path, "--torch_ckpt", ckpt, "--out",
         os.path.join(imported["training_params"]["callback_path"], "checkpoints_9.ckpt"),
         "--with-tokenizer"], capture_output=True, text=True, timeout=600, check=False)
    import_s = time.perf_counter() - t0
    check(res.returncode == 0, f"[import-ckpt] the importer failed:\n{res.stdout}{res.stderr}")
    with open(imported["tokenizer_params"]["tokenizer_path"], "rb") as f:
        check(f.read() == proc.serialized_model_proto(), "[import-ckpt] tokenizer bytes differ")
    t0 = time.perf_counter()
    out = run_cli("-c", cfg_path, "-m", "test-clean", "-i", 9, "--gready", "--verbose_val")
    cli_s = time.perf_counter() - t0
    printed = [ast.literal_eval(line) for line in re.findall(r"Predictions:\n (\[.*\])\n", out)]
    got_wer = float(re.search(r"Greedy Search WER : ([\d.]+)%", out).group(1))

    trainer = Trainer(imported, device="cuda")
    trainer.model.load_state_dict(weights, strict=True)
    tok = runtime.load_tokenizer(imported)
    ds = LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"], "test-clean",
                            vocab_size=cfg["tokenizer_params"]["vocab_size"])
    direct = []
    for batch in AsrBatchLoader(ds, 8, shuffle=False, drop_last=False).epoch(0):
        toks, n = greedy_decode(trainer.model.eval(), torch.from_numpy(batch["audio"][0]).cuda(),
                                torch.from_numpy(batch["audio_len"][0]).cuda())
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        direct.append(tok.decode([toks[b, : n[b]].tolist() for b in range(len(n))]))
    check(printed == direct, "[import-ckpt] the CLI's predictions differ from the in-process "
          "model's")
    say("import-ckpt", config="EfficientConformerCTCSmall", entries=len(original),
        dropped=2, step=4321, import_s=f"{import_s:.2f}", cli_s=f"{cli_s:.2f}",
        wer=f"{got_wer:.2f}", utterances=sum(map(len, direct)), predictions_equal=True,
        importer=res.stdout.strip().splitlines()[0])


def phase_cli_transducer(tmp, card_line):
    """Transducer Small through the CLI: its tokenizer (1000 pieces) and
    manifests, 1 epoch of 1 step with validation, greedy test-clean,
    eval_time_decoder."""
    from efficientconformer_torch.config import load_config

    cfg_path = cli_config(T_CONFIG, tmp, "transducer", 1)
    cfg = load_config(cfg_path)
    with spied_trainer() as (steps, _), native_bpe_spy() as bpe:
        train_out = run_cli("-c", cfg_path, "-m", "training", "--create_tokenizer", "-p",
                            "--steps_per_epoch", 1, "--val_steps", 1)
    check(bpe == {"native": 1, "python": 0}, f"tokenizer trainings {bpe}")
    accum = cfg["training_params"]["accumulated_steps"]
    n_att = cfg["encoder_params"]["num_blocks"] * accum
    check_steps("cli-transducer", steps, {0: n_att, 1: n_att, 2: n_att, 3: n_att, 4: accum,
                                         5: 2 * accum}, 1)
    wer_val = re.search(r"val: \{'WER': ([\d.]+)", train_out)
    check(wer_val is not None, "the validation WER line")
    out = run_cli("-c", cfg_path, "-m", "test-clean", "-i", 1, "--gready")
    test_wer = float(re.search(r"Greedy Search WER : ([\d.]+)%", out).group(1))
    out = run_cli("-c", cfg_path, "-m", "eval_time_decoder", "-i", 1, "--val_steps", 1)
    dec_s = float(re.search(r"eval time : ([\d.]+)s", out).group(1))
    from efficientconformer_torch.data.tokenizer import BpeTokenizer

    pieces = BpeTokenizer.load(cfg["tokenizer_params"]["tokenizer_path"]).vocab_size()
    (_, loss, _, step_ms), = epoch_lines(train_out)
    say("cli-transducer", config="EfficientConformerTransducerSmall", bpe_pieces=pieces,
        loss=f"{loss:.4f}", ms_per_step=step_ms, step_launches=steps[0]["launches"][:6],
        step_shape=steps[0]["shape"], val_wer=float(wer_val.group(1)), test_wer=test_wer,
        eval_time_decoder=f"{dec_s:.2f}s", card=f"'{card_line}'")


def phase_cli_lm(tmp, card_line):
    """LM-Transformer through the CLI: 1 step on the corpus with lm_mode
    validation on the dev transcripts, then validation-clean."""
    from efficientconformer_torch.config import load_config

    corpus = os.path.join(tmp, "librispeech-lm-norm.txt")
    cfg_path = cli_config(LM_CONFIG, tmp, "lm", 1)
    cfg = load_config(cfg_path)
    cfg["training_params"]["training_dataset_path"] = corpus
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with spied_trainer() as (steps, _):
        out = run_cli("-c", cfg_path, "-m", "training", "--steps_per_epoch", 1, "--val_steps", 1)
    accum = cfg["training_params"]["accumulated_steps"]
    n_att = cfg["lm_params"]["num_blocks"] * accum
    check_steps("cli-lm", steps, {6: n_att, 7: n_att, 8: n_att, 9: n_att}, 1)
    val = re.search(r"val: \{'MeanLoss': ([\d.]+)\}", out)
    check(val is not None, "the lm_mode validation line")
    (_, loss, _, step_ms), = epoch_lines(out)
    out = run_cli("-c", cfg_path, "-m", "validation-clean", "-i", 1)
    eval_loss, ppl = map(float, re.search(r"Eval Loss : (\S+) \| Perplexity : (\S+)",
                                          out).groups())
    check(math.isfinite(eval_loss), f"eval loss {eval_loss}")
    say("cli-lm", config="LM-Transformer", loss=f"{loss:.4f}", ms_per_step=step_ms,
        step_shape=steps[0]["shape"], step_launches=steps[0]["launches"][6:],
        val_loss=float(val.group(1)), eval_loss=eval_loss, perplexity=ppl,
        card=f"'{card_line}'")


# ---------------------------------------------------------------- beam search


def synth_ngram(vocab: int) -> str:
    """A synthetic ARPA 6-gram over ``vocab`` char-mapped tokens at the
    shipped files' shape (tests/ngram_synth.py, ~360k entries), written
    under build/ngram/ once."""
    import importlib.util

    path = os.path.join("build", "ngram", f"synth_{NGRAM_ORDER}gram_{vocab}.arpa")
    if not os.path.exists(path):
        spec = importlib.util.spec_from_file_location("ngram_synth", "tests/ngram_synth.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"   # the beams' CPU references may write it too
        module.synth_arpa(tmp, vocab=vocab, order=NGRAM_ORDER, seed=SEED)
        os.replace(tmp, path)
    return path


@contextlib.contextmanager
def count_syncs():
    """Counts the calls that make the host wait for the card (torch's sync
    debug mode warns at each): yields a dict whose "n" is set on exit."""
    import warnings

    box = {"n": 0}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield box
        box["n"] = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_ngram_device():
    """The device n-gram scorer on the card against the host ArpaLM, on
    seeded random token walks over the synthetic 6-gram of 256 tokens:
    scores within NGRAM_TOL, nodes (the host states, numbered as the
    packing numbers them) equal, context_node equal to the walked node.
    Then a lookup batch at the CTC beam's per-frame shape, timed."""
    from efficientconformer_torch.decoding.ngram import ArpaLM
    from efficientconformer_torch.decoding.ngram_device import DeviceNgram

    t0 = time.perf_counter()
    path = synth_ngram(256)
    t1 = time.perf_counter()
    arpa = ArpaLM(path)
    t2 = time.perf_counter()
    dev = DeviceNgram(arpa, 256, "cuda")
    t3 = time.perf_counter()
    node_id = {t: i for i, t in enumerate(
        [()] + sorted(k for k in arpa.table if len(k) < arpa.order))}
    n, steps = NGRAM_WALKS
    walks = np.random.default_rng(SEED + 30).integers(0, 256, (n, steps))
    tw = torch.from_numpy(walks).cuda()
    node = dev.start_state((n,))
    states = [arpa.start_state()] * n
    err, wrong_nodes = 0.0, 0
    for t in range(steps):
        sc, node = dev.score(node, tw[:, t])
        host = [arpa.score(states[i], int(walks[i, t])) for i in range(n)]
        states = [h[1] for h in host]
        err = max(err, float(np.abs(sc.cpu().numpy() - np.array([h[0] for h in host])).max()))
        wrong_nodes += int((node.cpu().numpy() != np.array([node_id[s] for s in states])).sum())
    ctx = dev.context_node(tw, torch.full((n,), steps, device="cuda"))
    check(err <= NGRAM_TOL, f"[ngram-device] scores {err} from the host ArpaLM")
    check(wrong_nodes == 0, f"[ngram-device] {wrong_nodes} nodes differ from the host states")
    check(torch.equal(ctx, node), "[ngram-device] context_node differs from the walked node")
    q_node = node[: CTC_BEAM_BATCH * BEAM].reshape(CTC_BEAM_BATCH, BEAM, 1).expand(-1, -1, 256)
    q_tok = torch.arange(256, device="cuda").expand_as(q_node)
    score_ms = cuda_ms(lambda: dev.score_from(q_node, q_tok))
    advance_ms = cuda_ms(lambda: dev.advance_node(q_node, q_tok))
    say("ngram-device", arpa=os.path.basename(path), order=dev.order, entries=dev.n_entries,
        nodes=int(dev.length.numel()), device_bytes=dev.nbytes(), write_s=f"{t1 - t0:.2f}",
        parse_s=f"{t2 - t1:.2f}", pack_s=f"{t3 - t2:.2f}", walks=f"{n}x{steps}",
        max_score_err=f"{err:.3g}", nodes_equal=True,
        lookup_batch=f"{CTC_BEAM_BATCH}x{BEAM}x256", score_from_ms=f"{score_ms:.3f}",
        advance_node_ms=f"{advance_ms:.3f}")
    return arpa, path


def phase_ctc_beam(card_line, arpa, arpa_path):
    """CTC Small, bf16 encoder, 32 ragged utterances of up to 10 s, the
    device prefix beam at W 16 with the config's n-gram weights over the
    synthetic 6-gram. Checks: on seeded peaky log-probs of the same shape
    the tokens of the host C++ beam (cutoff_top_n 0), utterance by
    utterance; on the model's own log-probs the tokens of the same search
    on the CPU, or, where they differ, best scores within BEAM_SCORE_TOL (a
    near-tie, counted). The device search accumulates in fp32 as the JAX
    package's does, and the C++ beam in double, so on the model's flat
    log-probs they may part at a near-tie of some frame and end far apart:
    their agreement there is counted, not checked. Then the main path
    timed: ms a batch, audio-s/s, the beam's share, rel-pos launches and
    the host reads before the result."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.decoding import ctc_beam
    from efficientconformer_torch.decoding.ctc_beam_device import (
        ctc_beam_search_device,
        prefix_beams,
    )

    dp = load_config(CONFIG)["decoding_params"]
    kw = dict(ngram=arpa, alpha=dp["ngram_alpha"], beta=dp["ngram_beta"])
    model = make_model("cuda", torch.bfloat16)
    rng = np.random.default_rng(SEED + 31)
    seconds = np.round(rng.uniform(5.0, TIME_SECONDS, CTC_BEAM_BATCH), 2)
    seconds[0] = TIME_SECONDS
    x, x_len = ragged_audio(seconds, "cuda", rng)

    @torch.inference_mode()
    def encode():
        logits, n = model(x, x_len)
        return torch.log_softmax(logits.float() / dp["tmp"], dim=-1), n

    def host(lp, n):
        return ctc_beam.beam_search_batch(lp.cpu().numpy(), n.cpu().numpy(), BEAM,
                                          lm_path=arpa_path, alpha=kw["alpha"], beta=kw["beta"])

    lp, n = encode()
    logits = torch.from_numpy(rng.standard_normal(tuple(lp.shape)) * 3.0).float()
    peaky = torch.log_softmax(logits, dim=-1).cuda()
    got = ctc_beam_search_device(peaky, n, BEAM, **kw)
    check(got == host(peaky, n), "[ctc-beam] peaky log-probs: the device beam's tokens differ "
          "from the host C++ beam's")

    def best(lp, n):
        pref, plen, score = prefix_beams(lp, n, BEAM, **kw)
        j = score.argmax(-1)
        rows = torch.arange(len(j), device=j.device)
        tokens, n_tok = pref[rows, j].cpu(), plen[rows, j].cpu()
        return [tokens[i, : n_tok[i]].tolist() for i in range(len(j))], score.max(-1).values.cpu()

    t0 = time.perf_counter()
    (got, got_sc), (want, want_sc) = best(lp, n), best(lp.cpu(), n.cpu())
    cpu_s = time.perf_counter() - t0
    differ = [i for i in range(CTC_BEAM_BATCH) if got[i] != want[i]]
    gap = max((abs(float(got_sc[i] - want_sc[i])) for i in differ), default=0.0)
    check(gap <= BEAM_SCORE_TOL, f"[ctc-beam] card vs CPU: tokens differ with best scores "
          f"{gap} apart")
    near_ties = len(differ)
    equal_host = sum(a == b for a, b in zip(got, host(lp, n)))

    # the main path: counts from 0, host reads before the result
    reset_rel_counts()
    with count_syncs() as syncs:
        state = prefix_beams(*encode(), BEAM, **kw)
    launches = rel_counts()
    torch.cuda.synchronize()
    check(launches[0] == launches[1] > 0, f"[ctc-beam] rel-pos launches {launches}")

    def run():
        return ctc_beam_search_device(*encode(), BEAM, **kw)

    def encode_only():
        encode()
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    batch_ms, enc_ms = wall_ms(run), wall_ms(encode_only)
    audio_s = float(x_len.sum()) / SAMPLE_RATE
    out = run()
    say("ctc-beam", config="EfficientConformerCTCSmall", batch=CTC_BEAM_BATCH,
        seconds=f"{seconds.min():.2f}-{seconds.max():.2f}", frames=int(n.max()), beam=BEAM,
        alpha=kw["alpha"], beta=kw["beta"], peaky_tokens_equal_host=True,
        card_vs_cpu_equal=CTC_BEAM_BATCH - near_ties, near_ties=near_ties,
        card_vs_cpu_s=f"{cpu_s:.1f}", model_tokens_equal_host=f"{equal_host}/{CTC_BEAM_BATCH}",
        ms_per_batch=f"{batch_ms:.2f}", encode_ms=f"{enc_ms:.2f}",
        beam_share=f"{1 - enc_ms / batch_ms:.3f}", audio_s_per_s=f"{audio_s / batch_ms * 1e3:.1f}",
        relpos_launches=launches[0], tc_launches=launches[1],
        host_reads_before_result=syncs["n"], final_beams=tuple(state[0].shape),
        tokens_per_utt=f"{np.mean([len(t) for t in out]):.1f}",
        peak_mib=torch.cuda.max_memory_allocated() // 2 ** 20, card=f"'{card_line}'")
    return launches[0], batch_ms


def digest(*items) -> str:
    """A hash of the bytes of tensors and of modules' state: the same
    weights and inputs on both sides of a card-vs-CPU check."""
    h = hashlib.sha256()
    for item in items:
        for t in item.state_dict().values() if isinstance(item, torch.nn.Module) else [item]:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def t_beam_setup():
    """[t-beam]'s decoding config, its fusion arguments (the synthetic
    6-gram over 1000 tokens), and its rng, which gives the card-vs-CPU
    check's audio first."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.decoding.ngram import ArpaLM

    cfg = load_config(T_CONFIG)
    dp = cfg["decoding_params"]
    t0 = time.perf_counter()
    arpa = ArpaLM(synth_ngram(1000))
    fusion = dict(beam_size=BEAM, tmp=dp["tmp"], lm_weight=dp["lm_weight"], lm_tmp=dp["lm_tmp"],
                  ngram=arpa, ngram_alpha=dp["ngram_alpha"], ngram_beta=dp["ngram_beta"])
    return cfg, fusion, time.perf_counter() - t0, np.random.default_rng(SEED + 32)


def t_host_beam_setup():
    """[t-host-beam]'s config, its 6-gram arguments, its rng (which gives
    the check's audio first) and its models on the CPU: Transducer Small,
    LM-Transformer and LM-RNN."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.decoding.ngram import ArpaLM
    from efficientconformer_torch.models import lm as lm_mod

    cfg = load_config(T_CONFIG)
    dp = cfg["decoding_params"]
    ng = dict(ngram=ArpaLM(synth_ngram(1000)), ngram_alpha=dp["ngram_alpha"],
              ngram_beta=dp["ngram_beta"], tmp=dp["tmp"])
    lms = {"transformer": make_lm("cpu", torch.float32),
           "rnn": lm_mod.build_model(LM_RNN_CONFIG, "cpu", torch.float32,
                                     torch.Generator().manual_seed(SEED))}
    return cfg, ng, np.random.default_rng(SEED + 42), make_transducer("cpu", torch.float32), lms


def host_beams():
    from efficientconformer_torch.decoding import rnnt_beam

    return (("transformer", rnnt_beam.beam_search), ("rnn", rnnt_beam.beam_search_batched))


def t_beam_reference() -> dict:
    """[t-beam]'s CPU side: its fp32 models, weights and audio made as the
    phase makes them, their digest, and (tokens, scores, seconds) of each
    routing (Graves False, ref_topk True)."""
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models import lm as lm_mod
    from efficientconformer_torch.models.transducer import greedy_token_cap

    cfg, fusion, _, rng = t_beam_setup()
    x, x_len = ragged_audio(T_BEAM_CHECK, "cpu", rng)
    cap = greedy_token_cap(cfg["encoder_params"], x.shape[1], MAX_CONSEC)
    model = make_transducer("cpu", torch.float32)
    lm = lm_mod.build_model(LM_CONFIG, "cpu", torch.float32, torch.Generator().manual_seed(SEED))
    out = {"digest": digest(model, lm, x)}
    for ref_topk in (False, True):
        t1 = time.perf_counter()
        toks, sc = beam_search_device(model, x, x_len, max_tokens=cap, lm_model=lm,
                                      ref_topk=ref_topk, return_scores=True, **fusion)
        out[ref_topk] = (toks, [float(v) for v in sc], time.perf_counter() - t1)
    return out


def t_host_beam_reference() -> dict:
    """[t-host-beam]'s CPU side, as ``t_beam_reference``: (tokens, scores,
    seconds) of each host beam by its LM's name."""
    cfg, ng, rng, model, lms = t_host_beam_setup()
    x, x_len = ragged_audio(T_HOST_BEAM_CHECK, "cpu", rng)
    dp = cfg["decoding_params"]
    out = {"digest": digest(model, *lms.values(), x)}
    for name, fn in host_beams():
        stats = {}
        t1 = time.perf_counter()
        toks = fn(model, x, x_len, beam_size=T_HOST_BEAM_W, lm_model=lms[name],
                  lm_weight=dp["lm_weight"], lm_tmp=dp["lm_tmp"], stats=stats, **ng)
        out[name] = (toks, [float(v) for v in stats["scores"]], time.perf_counter() - t1)
    return out


def beam_references(conn) -> None:
    """In a process of its own, which never touches the card and runs
    beside the card's phases: each beam phase's CPU side, sent down
    ``conn`` as (phase, its dict or {"error": traceback}) once it is done."""
    torch.set_num_threads(BEAM_REF_THREADS)
    for phase, fn in (("t-beam", t_beam_reference), ("t-host-beam", t_host_beam_reference)):
        try:
            conn.send((phase, fn()))
        except BaseException:
            conn.send((phase, {"error": traceback.format_exc()}))
    conn.close()


class BeamReferences:
    """``beam_references`` in a spawned process, started before the card's
    phases; ``get`` waits for a phase's references."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.conn, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=beam_references, args=(send,), daemon=True)
        self.proc.start()
        send.close()
        self.got = {}

    def get(self, phase: str) -> dict:
        t0 = time.perf_counter()
        while phase not in self.got:
            try:
                name, out = self.conn.recv()
            except EOFError:
                name, out = phase, {"error": f"the process ended, code {self.proc.exitcode}"}
            self.got[name] = out
        out = self.got[phase]
        check("error" not in out, f"[{phase}] the CPU references failed: {out.get('error')}")
        return dict(out, waited_s=time.perf_counter() - t0)

    def stop(self) -> None:
        self.proc.kill()
        self.proc.join()


def phase_t_beam(card_line, refs):
    """Transducer Small with LM-Transformer fused in (full width, random
    weights from SEED; the config's lm_weight, lm_tmp) and the synthetic
    6-gram over 1000 tokens (alpha 0.3, beta 1), W 16, tmp 1. Checks: card
    vs CPU on the same fp32 weights at 2 utterances of 2 and 1.5 s, Graves and
    ref_topk routing: tokens equal or, where they differ, final normalised
    scores within BEAM_SCORE_TOL (counted); the CPU side from ``refs``
    (``beam_references``), on weights and audio of the same digest. Then
    the main path: bf16 encoder, fp32 decode, 4 x 10 s: ms a batch,
    audio-s/s, fast and slow frames, pops, host reads, rel-pos launches,
    peak memory."""
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models import lm as lm_mod
    from efficientconformer_torch.models.transducer import greedy_token_cap

    cfg, fusion, ngram_s, rng = t_beam_setup()
    dp = cfg["decoding_params"]
    arpa = fusion["ngram"]
    x, x_len = ragged_audio(T_BEAM_CHECK, "cpu", rng)
    cap = greedy_token_cap(cfg["encoder_params"], x.shape[1], MAX_CONSEC)
    model = make_transducer("cuda", torch.float32)
    lm = lm_mod.build_model(LM_CONFIG, "cuda", torch.float32, torch.Generator().manual_seed(SEED))
    ref = refs.get("t-beam")
    check(ref["digest"] == digest(model, lm, x),
          "[t-beam] the CPU references ran on other weights or audio")
    checks = {}
    for ref_topk in (False, True):
        t1 = time.perf_counter()
        got, got_sc = beam_search_device(model, x.cuda(), x_len.cuda(), max_tokens=cap,
                                         lm_model=lm, ref_topk=ref_topk, return_scores=True,
                                         **fusion)
        card_s = time.perf_counter() - t1
        want, want_sc, cpu_s = ref[ref_topk]
        differ = [i for i in range(len(got)) if got[i] != want[i]]
        err = max((abs(float(got_sc[i]) - want_sc[i]) for i in differ), default=0.0)
        check(err <= BEAM_SCORE_TOL, f"[t-beam] ref_topk={ref_topk}: tokens differ from the "
              f"CPU's with final scores {err} apart")
        checks["ref_topk" if ref_topk else "graves"] = (
            f"{len(got) - len(differ)}/{len(got)} equal, {len(differ)} near-ties, "
            f"card {card_s:.1f}s cpu {cpu_s:.1f}s, "
            f"tokens {[len(t) for t in got]}")
    del model

    model = make_transducer("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    audio = (rng.standard_normal((T_BEAM_BATCH, n)) * 0.1).astype(np.float32)
    x, x_len = torch.from_numpy(audio).cuda(), torch.full((T_BEAM_BATCH,), n, device="cuda")
    cap = greedy_token_cap(cfg["encoder_params"], n, MAX_CONSEC)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_rel_counts()
    t1 = time.perf_counter()
    out = beam_search_device(model, x, x_len, max_tokens=cap, lm_model=lm, stats=stats, **fusion)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t1) * 1e3
    launches = rel_counts()
    check(launches[0] == launches[1] > 0, f"[t-beam] rel-pos launches {launches}")
    check(all(len(t) <= cap for t in out), "[t-beam] more tokens than the cap")
    say("t-beam", config="EfficientConformerTransducerSmall+LM-Transformer", batch=T_BEAM_BATCH,
        seconds=TIME_SECONDS, beam=BEAM, max_tokens=cap, lm_weight=dp["lm_weight"],
        ngram_alpha=dp["ngram_alpha"], ngram_beta=dp["ngram_beta"], ngram_s=f"{ngram_s:.2f}",
        check_graves=f"'{checks['graves']}'", check_ref_topk=f"'{checks['ref_topk']}'",
        cpu_wait_s=f"{ref['waited_s']:.1f}", ms_per_batch=f"{batch_ms:.1f}",
        audio_s_per_s=f"{T_BEAM_BATCH * TIME_SECONDS / batch_ms * 1e3:.3f}",
        fast_frames=stats["fast_frames"], slow_frames=stats["slow_frames"], pops=stats["pops"],
        ms_per_pop=f"{batch_ms / max(stats['pops'], 1):.2f}", host_reads=stats["host_reads"],
        relpos_launches=launches[0], tc_launches=launches[1],
        carry_store_mib=stats["carry_store_bytes"] // 2 ** 20,
        peak_mib=torch.cuda.max_memory_allocated() // 2 ** 20,
        tokens_per_utt=f"{np.mean([len(t) for t in out]):.1f}", card=f"'{card_line}'")
    return launches[0], batch_ms, arpa


# ---------------------------------------------------------------- the host beams


def lm_step_inputs(b, nk, gen):
    """q (B, H, 1, dh), k and v (B, H, Nk, dh) as strided views of (B, N, H,
    dh), a (B, H, 1, Nk) fp32 bias and the scale, at LM-Transformer's heads."""
    p = lm_params()
    h, dh = p["num_heads"], p["dim_model"] // p["num_heads"]

    def heads(n):
        return torch.randn(b, n, h, dh, generator=gen).cuda().transpose(1, 2)
    bias = torch.randn(b, h, 1, nk, generator=gen).cuda()
    return heads(1), heads(nk), heads(nk), bias, 1.0 / math.sqrt(dh)


def check_lm_step_case(phase, b, nk, gen):
    """The bias forward at one query row against Nk keys vs its fp32 plain
    version, fp32 (the FMA kernel) and bf16 (the tensor-core kernel,
    counted): the two largest errors, each held to its gate."""
    from efficientconformer_torch.ops import bias_attention as BA

    q, k, v, bias, scale = lm_step_inputs(b, nk, gen)
    reset_launch_counts()
    o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
    want_o, want_lse = BA.reference_bias_attention(q, k, v, bias, scale)
    e32 = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    o16, _ = BA.bias_attention_fwd(q16, k16, v16, bias, scale)
    want16, _ = BA.reference_bias_attention(q16, k16, v16, bias, scale)
    e16 = (o16.float() - want16.float()).abs().max().item()
    check(e32 <= KERNEL_FP32_TOL, f"[{phase}] B {b} Nk {nk} fp32: {e32}")
    check(e16 <= KERNEL_BF16_TOL, f"[{phase}] B {b} Nk {nk} bf16: {e16}")
    check(bias_launch_counts()[0] == 2 and bias_tc_counts()[0] == 1,
          f"[{phase}] B {b} Nk {nk}: launches {bias_launch_counts()}, "
          f"tensor-core {bias_tc_counts()}, expected the bf16 one on the tensor cores")
    return e32, e16


def phase_lm_step_kernel():
    """The bias forward kernel at one query row, the growing-cache LM
    step's shape (a (B, H, 1, Nk) bias of skewed rel-pos scores, no mask):
    B 1 (the per-utterance host beam) and 16, H 12, dh 64, Nk across the
    64-key tile edges up to past the longest cache of [t-host-beam]'s main
    path, fp32 on the FMA kernel and bf16 on the tensor-core kernel
    (counted), each vs the fp32 plain version on the same inputs. Then
    timed at B 1, Nk 100 in fp32, the type the beam's LM step runs in, from
    CUDA graphs beside the plain version, SDPA with the bias as its mask
    and the byte bound."""
    from efficientconformer_torch.ops import bias_attention as BA

    p = lm_params()
    h, dh = p["num_heads"], p["dim_model"] // p["num_heads"]
    gen = torch.Generator().manual_seed(SEED + 40)
    err32 = err16 = 0.0
    cases = 0
    for b in (1, 16):
        for nk in LM_STEP_KEYS:
            e32, e16 = check_lm_step_case("lm-step-kernel", b, nk, gen)
            err32, err16, cases = max(err32, e32), max(err16, e16), cases + 1
    b, nk = 1, LM_STEP_TIME_KEYS
    q, k, v, bias, scale = lm_step_inputs(b, nk, gen)
    fns = {"kernel": lambda: BA.bias_attention_fwd(q, k, v, bias, scale),
           "plain": lambda: BA.reference_bias_attention(q, k, v, bias, scale),
           "library": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             scale=scale)}
    row = {name: graph_ms(fn) for name, fn in fns.items()}
    row["bound"], row["bound_by"] = bound(*bias_cost(b, h, 1, nk, dh, dh, 4, False), FP32_PEAK)
    say("lm-step-kernel", B="1,16", H=h, Nq=1, Nk=",".join(map(str, LM_STEP_KEYS)), dh=dh,
        cases=cases, fp32_max_err=f"{err32:.3g}", bf16_max_err=f"{err16:.3g}",
        bf16_route="tensor-core")
    say("lm-step-kernel-time", B=b, H=h, Nq=1, Nk=nk, dh=dh, dtype="float32",
        bound_by=row["bound_by"], library="sdpa fwd, bias as mask",
        **{f"{key}_ms": f"{val:.4f}" for key, val in row.items() if key != "bound_by"})
    return err32, err16, row


def phase_growing_cache():
    """LM-Transformer at full width and depth (12 x 768, 12 heads), fp32:
    LM_CACHE_TOKENS tokens (a blank, then seeded tokens) stepped on the
    growing cache from None equal, step by step, the fixed-capacity step
    and the teacher-forced forward on the card, and the growing cache's
    steps on the CPU. The bias launches of the growing steps, counted: 12
    a step."""
    import copy

    lm_cpu = make_lm("cpu", torch.float32)
    lm = copy.deepcopy(lm_cpu).cuda()
    rng = np.random.default_rng(SEED + 41)
    b, n = 2, LM_CACHE_TOKENS
    x = torch.from_numpy(rng.integers(1, 256, (b, n - 1))).cuda()
    feed = F.pad(x, (1, 0))
    errs = {"fixed": 0.0, "forward": 0.0, "cpu": 0.0}
    with torch.inference_mode():
        teacher = lm(x)
        fixed = lm.init_carry_fixed(b, n, "cuda")
        grow = grow_cpu = None
        launches = []
        for t in range(n):
            reset_launch_counts()
            got, grow = lm.step(feed[:, t], grow)
            torch.cuda.synchronize()
            launches.append(bias_launch_counts()[0])
            want, fixed = lm.step(feed[:, t], fixed)
            cpu, grow_cpu = lm_cpu.step(feed[:, t].cpu(), grow_cpu)
            errs["fixed"] = max(errs["fixed"], (got - want).abs().max().item())
            errs["forward"] = max(errs["forward"], (got - teacher[:, t]).abs().max().item())
            errs["cpu"] = max(errs["cpu"], (got.cpu() - cpu).abs().max().item())
    blocks = lm_params()["num_blocks"]
    check(max(errs.values()) <= KERNEL_FP32_TOL, f"[growing-cache] errors {errs}")
    check(set(launches) == {blocks}, f"[growing-cache] bias launches a step {set(launches)}, "
          f"expected {blocks}")
    check(grow[0]["k"].shape == (b, n, lm_params()["dim_model"]), "[growing-cache] cache shape")
    say("growing-cache", config="LM-Transformer", batch=b, tokens=n, dtype="float32",
        **{f"vs_{key}_max_err": f"{val:.3g}" for key, val in errs.items()},
        bias_launches_per_step=blocks, bias_launches=sum(launches))


def host_vs(got, got_sc, want, want_sc):
    """(utterances whose tokens differ, the largest gap of their best
    normalised scores)."""
    differ = [i for i in range(len(got)) if got[i] != want[i]]
    return len(differ), max((abs(float(got_sc[i]) - float(want_sc[i])) for i in differ),
                            default=0.0)


def phase_t_host_beam(card_line, refs):
    """The host Transducer beams (decoding/rnnt_beam.py, ECF_HOST_BEAM=1):
    Transducer Small (seeded random weights, fp32) with LM-Transformer fused
    through ``beam_search`` (the growing cache) and with LM-RNN through
    ``beam_search_batched``, each with the synthetic 6-gram over 1000 tokens
    and the config's weights, W 4, at 2 utterances of 2 and 1.5 s: card vs
    CPU tokens equal or final normalised scores within BEAM_SCORE_TOL (near
    ties, counted), the CPU side from ``refs`` on weights and audio of the
    same digest; host beam vs the device beam on the card on the same
    inputs and weights, held the same way. Then the main
    path: one 4 s utterance at the config's W with the bf16 encoder and the
    fp32 LM-Transformer: ms a batch, pops, ms a pop, the bias launches (12
    a pop) and rel-pos launches (15), each counted from 0, and the longest
    cache an LM step attended, where the bias kernel is held to its plain
    version again."""
    import copy

    from efficientconformer_torch.decoding import rnnt_beam
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models.transducer import greedy_token_cap

    t_phase = time.perf_counter()
    cfg, ng, rng, t_cpu, lms_cpu = t_host_beam_setup()
    dp = cfg["decoding_params"]
    x, x_len = ragged_audio(T_HOST_BEAM_CHECK, "cpu", rng)
    cap = greedy_token_cap(cfg["encoder_params"], x.shape[1], MAX_CONSEC)
    ref = refs.get("t-host-beam")
    check(ref["digest"] == digest(t_cpu, *lms_cpu.values(), x),
          "[t-host-beam] the CPU references ran on other weights or audio")
    model = copy.deepcopy(t_cpu).cuda()
    lms = {k: copy.deepcopy(m).cuda() for k, m in lms_cpu.items()}
    del t_cpu, lms_cpu
    checks = {}
    for name, fn in host_beams():
        stats = {}
        t1 = time.perf_counter()
        toks = fn(model, x.cuda(), x_len.cuda(), beam_size=T_HOST_BEAM_W, lm_model=lms[name],
                  lm_weight=dp["lm_weight"], lm_tmp=dp["lm_tmp"], stats=stats, **ng)
        card_s, pops = time.perf_counter() - t1, stats["pops"]
        want, want_sc, cpu_s = ref[name]
        n_tie, gap = host_vs(toks, stats["scores"], want, want_sc)
        check(gap <= BEAM_SCORE_TOL, f"[t-host-beam] {name}: card vs CPU tokens differ with "
              f"final scores {gap} apart")
        dev_toks, dev_sc = beam_search_device(
            model, x.cuda(), x_len.cuda(), beam_size=T_HOST_BEAM_W, max_tokens=cap,
            lm_model=lms[name], lm_weight=dp["lm_weight"], lm_tmp=dp["lm_tmp"],
            return_scores=True, **ng)
        n_dev, dev_gap = host_vs(toks, stats["scores"], dev_toks, dev_sc)
        check(dev_gap <= BEAM_SCORE_TOL, f"[t-host-beam] {name}: host vs device beam tokens "
              f"differ with final scores {dev_gap} apart")
        checks[name] = (f"{len(x) - n_tie}/{len(x)} equal, {n_tie} near-ties; vs device beam "
                        f"{len(x) - n_dev}/{len(x)} equal, gap {dev_gap:.3g}; card "
                        f"{card_s:.1f}s cpu {cpu_s:.1f}s, pops "
                        f"{pops}, tokens {[len(t) for t in toks]}")
    del model, lms

    lm = make_lm("cuda", torch.float32)
    longest = [0]
    lm_step = lm.step

    def step_spy(tok, carry):
        # the keys of each LM step of the main path: a shape, read on the host
        out = lm_step(tok, carry)
        longest[0] = max(longest[0], out[1][0]["k"].shape[1])
        return out

    lm.step = step_spy
    model = make_transducer("cuda", torch.bfloat16)
    n = int(T_HOST_BEAM_SECONDS * SAMPLE_RATE)
    audio = torch.from_numpy((rng.standard_normal((1, n)) * 0.1).astype(np.float32)).cuda()
    stats = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    out = rnnt_beam.beam_search(model, audio, torch.tensor([n], device="cuda"),
                                beam_size=dp["beam_size"], lm_model=lm,
                                lm_weight=dp["lm_weight"], lm_tmp=dp["lm_tmp"], stats=stats,
                                **ng)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t1) * 1e3
    rel, bias, bias_tc = rel_counts(), bias_launch_counts(), bias_tc_counts()
    blocks = lm_params()["num_blocks"]
    check(rel[0] == rel[1] > 0, f"[t-host-beam] rel-pos launches {rel}")
    check(bias[0] == blocks * stats["pops"] > 0,
          f"[t-host-beam] bias launches {bias[0]} for {stats['pops']} pops")
    # the kernel at the main path's longest cache, beside [lm-step-kernel]'s
    # grid of Nk, which must reach past it
    check(longest[0] <= max(LM_STEP_KEYS), f"[t-host-beam] the longest cache {longest[0]} "
          f"lies past [lm-step-kernel]'s largest Nk {max(LM_STEP_KEYS)}")
    longest_err = check_lm_step_case("t-host-beam", 1, longest[0],
                                     torch.Generator().manual_seed(SEED + 44))
    say("t-host-beam", config="EfficientConformerTransducerSmall+LM-Transformer|LM-RNN",
        check_beam=T_HOST_BEAM_W, check_seconds=T_HOST_BEAM_CHECK,
        check_transformer=f"'{checks['transformer']}'", check_rnn=f"'{checks['rnn']}'",
        cpu_wait_s=f"{ref['waited_s']:.1f}",
        seconds=T_HOST_BEAM_SECONDS, beam=dp["beam_size"], ms_per_batch=f"{batch_ms:.1f}",
        pops=stats["pops"], ms_per_pop=f"{batch_ms / stats['pops']:.2f}",
        bias_launches=bias[0], bias_tc_launches=bias_tc[0], relpos_launches=rel[0],
        tokens=len(out[0]), longest_cache=longest[0],
        longest_cache_max_err=f"'fp32 {longest_err[0]:.3g} bf16 {longest_err[1]:.3g}'",
        phase_s=f"{time.perf_counter() - t_phase:.1f}",
        card=f"'{card_line}'")
    return bias[0], rel[0], batch_ms / stats["pops"]


# ---------------------------------------------------------------- streaming and serving


def stream_bias(b, h, frames, g, left, right, lengths, gen):
    """The (B, H, N, N) bias a causal (right 0) or limited-context encoder
    layer hands the bias kernel over ``frames`` stage frames, and its
    (B, 1, N, N) mask: skewed rel-pos-like scores plus the streaming mask,
    padded to a multiple of G with 1.0 and taken at each group's first
    frame, times -1e9. Query rows past a row's length plus the left context
    see no valid key. Group padding alone masks no whole row: the first
    frame of a group is always a real one."""
    from efficientconformer_torch.ops import masks as M
    from efficientconformer_torch.ops.attention import NEG_INF

    mask = M.pad_mask_to_multiple(M.streaming_mask(frames, lengths, left, right), g)
    mask = mask[:, :, ::g, ::g]
    n = mask.shape[-1]
    return torch.randn(b, h, n, n, generator=gen) * 0.5 + mask * NEG_INF, mask


def stream_stage_shapes(enc_params, window_frames):
    """(stage frames, G, head width) of each stage of a window of
    ``window_frames`` output frames."""
    from efficientconformer_torch import streaming as S
    from efficientconformer_torch.config import resolve_block_configs

    sub = 2 ** enc_params.get("subsampling_layers", 1)
    total = S.total_stride(enc_params)
    shapes = []
    for blk, s_in in zip(resolve_block_configs(enc_params), S._strides_per_stage(enc_params)):
        shape = (window_frames * total // (sub * s_in), blk.att_group_size,
                 blk.att_group_size * blk.dim_model // blk.num_heads)
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def check_bias_window(phase, p, window_frames, b, left, right, gen):
    """bias_attention_fwd vs reference_bias_attention at the stage shapes of
    a ``window_frames`` window of the encoder ``p`` (left and right
    context as given) over ``b`` rows of ragged lengths, fp32 and bf16, with
    the error on the fully masked rows also on its own and those rows held
    to the mean of V. Returns the largest fp32 error and, by shape, the
    bf16 inputs (q, k, v, bias, scale) and (B, H, N, dh, G, stage frames)."""
    from efficientconformer_torch.ops import bias_attention as BA

    h = p["num_heads"]
    worst, shapes = 0.0, []
    for frames, g, dh in stream_stage_shapes(p, window_frames):
        lengths = torch.linspace(1, frames, b).round().long()
        bias, mask = stream_bias(b, h, frames, g, left, right, lengths, gen)
        n = bias.shape[-1]
        dead = (mask == 1.0).all(-1)[:, 0].cuda()                  # (B, N)
        rows = dead[:, None, :].expand(b, h, n)
        check(bool(dead.any()), f"{phase} stage {frames}x{g}: no fully masked row")
        q, k, v = (torch.randn(b, n, h, dh, generator=gen).cuda().transpose(1, 2)
                   for _ in range(3))
        bias, scale = bias.cuda(), 1.0 / math.sqrt(dh)
        errs = {}
        for dtype, tol in ((torch.float32, KERNEL_FP32_TOL), (torch.bfloat16, KERNEL_BF16_TOL)):
            args = [t.to(dtype) for t in (q, k, v)]
            reset_launch_counts()
            o, lse = BA.bias_attention_fwd(*args, bias, scale)
            check(BA.bias_attention.launches == 1 and
                  BA.bias_attention.tc_launches == (dtype == torch.bfloat16),
                  f"{phase} stage {frames}x{g} {dtype}: the wrong route")
            want_o, want_lse = BA.reference_bias_attention(*args, bias, scale)
            diff = (o.float() - want_o.float()).abs()
            err, err_dead = diff.max().item(), diff[rows].max().item()
            mean_v = args[2].float().mean(2, keepdim=True).expand(b, h, n, dh)
            err_mean = (o.float() - mean_v).abs()[rows].max().item()
            err_lse = (lse - want_lse).abs().max().item()
            check(err <= tol and err_dead <= tol and err_mean <= tol,
                  f"{phase} stage {frames}x{g} {dtype}: |O| {err}, masked rows {err_dead}, "
                  f"vs mean V {err_mean} > {tol}")
            if dtype == torch.float32:
                check(err_lse <= KERNEL_FP32_TOL,
                      f"{phase} stage {frames}x{g}: |LSE| {err_lse}")
                worst = max(worst, err)
            errs[str(dtype).removeprefix("torch.")] = (err, err_dead, err_mean)
        say(phase, B=b, H=h, N=n, dh=dh, G=g, stage_frames=frames, left_context=left,
            right_context=right, masked_rows=int(dead.sum()),
            fp32_err=f"{errs['float32'][0]:.3g}", fp32_masked_row_err=f"{errs['float32'][1]:.3g}",
            fp32_vs_mean_v=f"{errs['float32'][2]:.3g}", bf16_err=f"{errs['bfloat16'][0]:.3g}",
            bf16_masked_row_err=f"{errs['bfloat16'][1]:.3g}", tol=f"{KERNEL_FP32_TOL}/{KERNEL_BF16_TOL}")
        shapes.append(((*(t.to(torch.bfloat16) for t in (q, k, v)), bias, scale),
                       (b, h, n, dh, g, frames)))
    return worst, shapes


def phase_stream_kernel():
    """bias_attention_fwd vs reference_bias_attention at the three stage
    shapes of the causal flagship (left context STREAM_LEFT) on a serving
    window (history 64, chunk 16, lookahead 4: 88 output frames) at
    STREAM_SLOTS rows (check_bias_window); then each shape timed in bf16
    from CUDA graphs beside the plain version, SDPA with the bias as its
    mask and the bound, as [lm-kernel-time]. Returns the largest fp32
    error and the summed times."""
    from efficientconformer_torch import streaming as S
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import bias_attention as BA

    p = load_config(CONFIG)["encoder_params"]
    geo = S.WindowGeometry(p, **SERVE_GEOMETRY)
    gen = torch.Generator().manual_seed(SEED + 20)
    worst, shapes = check_bias_window("stream-kernel", p, geo.window_frames, STREAM_SLOTS,
                                      STREAM_LEFT, 0, gen)
    totals = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    flops = nbytes = 0.0
    for (q16, k16, v16, bias, scale), (b, h, n, dh, g, frames) in shapes:
        mask16 = bias.to(torch.bfloat16)
        row = {"kernel": graph_ms(lambda: BA.bias_attention_fwd(q16, k16, v16, bias, scale)),
               "plain": graph_ms(lambda: BA.reference_bias_attention(q16, k16, v16, bias, scale)),
               "library": graph_ms(lambda: F.scaled_dot_product_attention(
                   q16, k16, v16, attn_mask=mask16, scale=scale))}
        cost = bias_cost(b, h, n, n, dh, dh, 2, False)
        row["bound"], bound_by = bound(*cost)
        flops, nbytes = flops + cost[0], nbytes + cost[1]
        for key in totals:
            totals[key] += row[key]
        say("stream-kernel-time", B=b, H=h, N=n, dh=dh, G=g, stage_frames=frames,
            bound_by=bound_by, library="sdpa fwd, bias as mask",
            **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    totals["bound"], totals["bound_by"] = bound(flops, nbytes)
    return worst, totals


def ctc_model(enc_params, dtype, vocab=None):
    """A CTC model over ``enc_params`` at the flagship's vocabulary (or
    ``vocab``), on the card, weights from SEED as make_model."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_

    p = dict(enc_params)
    if dtype != torch.float32:
        p["compute_dtype"] = str(dtype).removeprefix("torch.")
    model = ModelCTC(p, vocab or load_config(CONFIG)["tokenizer_params"]["vocab_size"])
    init_params_(model, torch.Generator().manual_seed(SEED))
    return perturb_norms_(model.to("cuda").eval())


def stream_exact_case(phase, name, p, seconds, rng, gen):
    """One encoder ``p`` streamed as [stream-exact] streams it (see
    phase_stream_exact): its bias kernel held to the plain version at the
    session's window shapes, then two ragged rows of ``seconds`` streamed in
    fp32 and held to the batch forward. Returns its bias and rel-pos
    launches and the largest fp32 kernel error."""
    from efficientconformer_torch import streaming as S
    from efficientconformer_torch.config import encoder_output_frames
    from efficientconformer_torch.ops import bias_attention as BA

    model = ctc_model(p, torch.float32)
    causal = bool(p.get("causal"))
    look = 2 if causal else S.suggested_lookahead_frames(p)
    sess = S.StreamingEncoderSession(model, p, batch_size=2, chunk_frames=16,
                                     lookahead_frames=look, device="cuda")
    err, _ = check_bias_window(f"{phase}-kernel", p, sess.window_frames, 2,
                               p["left_context"], 0 if causal else p["right_context"], gen)
    n = [int(s * SAMPLE_RATE) for s in seconds]
    audio = (rng.standard_normal((2, n[0])) * 0.1).astype(np.float32)
    audio[1, n[1]:] = 0.0
    reset_launch_counts()
    t0 = time.perf_counter()
    ems, pos = [], 0
    for bite in itertools.cycle((0.7, 1.9, 0.4)):
        step = int(bite * SAMPLE_RATE)
        ems += sess.push(audio[:, pos:pos + step])
        pos += step
        if pos >= n[0]:
            break
    ems += sess.finish(np.array(n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got_launches, rel = BA.bias_attention.launches, rel_counts()[0]
    check(got_launches == len(model.encoder.blocks) * len(ems) and rel == 0,
          f"{name}: {got_launches} bias / {rel} rel-pos launches for {len(ems)} windows")
    got = np.concatenate([em.valid for em in ems], axis=1)
    padded = np.concatenate([audio, np.zeros((2, sess.window_samples), np.float32)], 1)
    with torch.inference_mode():
        want, _ = model(torch.from_numpy(padded).cuda(), torch.tensor(n, device="cuda"))
    want = want.float().cpu().numpy()
    # the limited encoder's last `look` frames: past a row's length
    # plus the left context, query rows are fully masked and average V
    # over every key of the row, the padding included, and the
    # non-causal convs carry that into these frames; the batch forward
    # pads otherwise than a window, so here streamed and batch differ in
    # the JAX package too, by as much
    # (tests/test_torch_port_streaming.py::test_finite_context_tail_matches_jax):
    # held apart, not to the padded batch forward
    tail = 0 if causal else look
    errs, tail_errs, tail_over = [], [0.0], 0
    for i in range(2):
        cap = encoder_output_frames(p, n[i])
        check(got.shape[1] >= cap, f"{name}: {got.shape[1]} frames emitted, {cap} expected")
        errs.append(float(np.abs(got[i, :cap - tail] - want[i, :cap - tail]).max()))
        if tail:
            d = np.abs(got[i, cap - tail:cap] - want[i, cap - tail:cap]).max(-1)
            tail_errs.append(float(d.max()))
            tail_over += int((d > STREAM_TOL).sum())
    agree = float(np.mean([(got[i, :c].argmax(-1) == want[i, :c].argmax(-1)).mean()
                           for i, c in enumerate(encoder_output_frames(p, m) for m in n)]))
    check(max(errs) <= STREAM_TOL, f"{name}: streamed vs batch |diff| {errs} > {STREAM_TOL}")
    say(phase, config=name, left_context=p["left_context"],
        right_context=0 if causal else p["right_context"], seconds=list(seconds),
        history=sess.history_frames, chunk=sess.chunk_frames, lookahead=look,
        window_frames=sess.window_frames, windows=len(ems), dtype="float32",
        max_abs_diff=f"{max(errs):.3g}", tol=STREAM_TOL, tail_frames=tail,
        tail_max_abs_diff=f"{max(tail_errs):.3g}", tail_frames_over_tol=tail_over,
        argmax_agreement=f"{agree:.6f}", bias_launches=got_launches, wall_s=f"{wall:.2f}")
    return got_launches, rel, err


def phase_stream_exact():
    """The flagship made causal (left context STREAM_EXACT_LEFT), and made
    limited-context (left STREAM_EXACT_LEFT, right 2) at the suggested
    lookahead, streamed in fp32 through StreamingEncoderSession at the
    suggested history over two ragged rows: the streamed logits equal the
    batch forward on the zero-padded utterance on every valid frame within
    STREAM_TOL (tests/test_streaming_runtime.py:55, :233), but for the
    limited encoder's last suggested-lookahead frames, whose difference is
    printed on its own (see below). Every attention layer takes the bias
    kernel, which is first held to its plain version at each session's
    window shapes (check_bias_window, two rows). Returns the bias and the
    rel-pos launches of the two sessions and the largest fp32 kernel
    error."""
    from efficientconformer_torch.config import load_config

    base = load_config(CONFIG)["encoder_params"]
    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator().manual_seed(SEED + 24)
    launches = rel_launches = 0
    worst = 0.0
    for name, p, seconds in (
            ("causal", dict(base, causal=True, left_context=STREAM_EXACT_LEFT), (30.0, 24.0)),
            ("limited", dict(base, left_context=STREAM_EXACT_LEFT, right_context=2),
             (40.0, 36.0))):
        got_launches, rel, err = stream_exact_case("stream-exact", name, p, seconds, rng, gen)
        launches, rel_launches, worst = launches + got_launches, rel_launches + rel, max(worst, err)
    return launches, rel_launches, worst


def recorded_session(encode, params):
    """A batch-1 StreamingEncoderSession at SERVE_GEOMETRY whose
    ``emitted_frames()`` gives the frames it emitted, in order."""
    from efficientconformer_torch import streaming as S

    sess = S.StreamingEncoderSession(encode, params, device="cuda", **SERVE_GEOMETRY)
    log, push, finish = [], sess.push, sess.finish

    def push_(samples):
        out = push(samples)
        log.extend(out)
        return out

    def finish_(x_len=None):
        out = finish(x_len)
        log.extend(out)
        return out

    sess.push, sess.finish = push_, finish_
    sess.emitted_frames = lambda: torch.cat([em.frames[0, em.first:em.last] for em in log])
    return sess


def recording(decoder, outputs):
    """``decoder`` (a server decoder) that also keeps, for each window step,
    which stream each row held and the frames it emitted; ``outputs`` is the
    list the server's encode function appends each step's frames to. Its
    ``emitted_frames(sid)`` is the stream's emitted frames, in order."""
    consume, bind = decoder.consume, decoder.bind
    log = []

    def bind_(server):
        decoder.server = server
        bind(server)

    def consume_(step_out, metas):
        log.append([(decoder.server._slots[i].stream_id, i, f, l) for i, f, l in metas])
        consume(step_out, metas)

    def emitted_frames(sid):
        return torch.cat([outputs[step][i, f:l] for step, metas in enumerate(log)
                          for s, i, f, l in metas if s == sid])

    decoder.bind, decoder.consume, decoder.emitted_frames = bind_, consume_, emitted_frames
    return decoder


def serve_schedule(srv, audios, rng):
    """The staggered schedule of tests/test_serving.py:39 at serving scale:
    four streams submitted at once, one more every other tick; each open
    stream pushed a bite of 0.3-2 s a tick and ended once pushed whole.
    Returns the results by stream and the ticks run."""
    pos = {}
    queue = list(range(len(audios)))
    ticks = 0
    while len(srv._results) < len(audios):
        if queue and (ticks == 0 or ticks % 2 == 1):
            for _ in range(4 if ticks == 0 else 1):
                if queue:
                    i = queue.pop(0)
                    srv.submit(f"s{i}")
                    pos[i] = 0
        for i, at in list(pos.items()):
            if at is None:
                continue
            step = int(rng.uniform(0.3, 2.0) * SAMPLE_RATE)
            srv.push(f"s{i}", audios[i][at:at + step])
            pos[i] = at + step
            if pos[i] >= audios[i].size:
                srv.end(f"s{i}")
                pos[i] = None
        srv.tick()
        ticks += 1
        check(ticks < 10_000, "the serving schedule did not finish")
    return {sid: list(toks) for sid, toks in srv._results.items()}, ticks


def near_ties(got, want):
    """Frames where the argmax of two logit rows (frames, V) differ."""
    return int((got.argmax(-1) != want.argmax(-1)).sum())


def phase_serve_slice(card_line):
    """StreamingServer over the full-context flagship (CTC) and Transducer
    Small, bf16, history 64, chunk 16, lookahead 4: SERVE_STREAMS streams of
    SERVE_SECONDS through SERVE_SLOTS slots on serve_schedule. First the
    rel-pos forward kernel is held to its plain version at the window's
    stage shapes over SERVE_SLOTS and RATE_SLOTS rows (check_forward). Each
    stream's frames (the CTC logits, the Transducer's encoder frames) must
    lie within SERVE_FRAME_TOL of the port's single-stream StreamingCTC /
    StreamingTransducer on the same card and weights, so a CTC frame whose
    argmax differs is a tie within twice the tolerance; the streams whose
    tokens differ and those CTC frames are counted. The server's launches
    are counted: rel-pos all on the tensor-core route, bias none. Returns
    (rel-pos, bias) launches and the largest fp32 and bf16 kernel errors."""
    from efficientconformer_torch import serving as SV
    from efficientconformer_torch import streaming as S
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import bias_attention as BA

    rng = np.random.default_rng(SEED + 22)
    seconds = np.linspace(*SERVE_SECONDS, SERVE_STREAMS)
    rng.shuffle(seconds)
    audios = [(rng.standard_normal(int(s * SAMPLE_RATE)) * 0.1).astype(np.float32)
              for s in seconds]
    gen = torch.Generator().manual_seed(SEED + 25)
    launches = bias_launches = 0
    errs = (0.0, 0.0)
    for kind in ("ctc", "transducer"):
        model = (make_model if kind == "ctc" else make_transducer)("cuda", torch.bfloat16)
        encode = model if kind == "ctc" else model.encode
        params = load_config(CONFIG if kind == "ctc" else T_CONFIG)["encoder_params"]
        window_s = S.WindowGeometry(params, **SERVE_GEOMETRY).window_samples / SAMPLE_RATE
        for rows in (SERVE_SLOTS, RATE_SLOTS):
            got_errs = check_forward(f"serve-kernel-{kind}", params, window_s, gen, rows)
            errs = tuple(map(max, errs, got_errs))
        outputs = []

        def recorded_encode(a, n):
            out = encode(a, n)
            outputs.append(out[0])
            return out

        decoder = recording(SV.CTCGreedyDecoder() if kind == "ctc" else
                            SV.TransducerGreedyDecoder(model), outputs)
        srv = SV.StreamingServer(recorded_encode, params, num_slots=SERVE_SLOTS,
                                 decoder=decoder, device="cuda", **SERVE_GEOMETRY)
        reset_launch_counts()
        t0 = time.perf_counter()
        got, ticks = serve_schedule(srv, audios, np.random.default_rng(SEED + 23))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rel, rel_tc = rel_counts()[:2]
        bias = BA.bias_attention.launches
        launches, bias_launches = launches + rel, bias_launches + bias
        check(rel > 0 and rel_tc == rel and bias == 0, f"serve-slice {kind}: rel-pos "
              f"launches {rel}, {rel_tc} on the tensor cores, bias launches {bias}")
        differ = ties = 0
        worst = peak = 0.0
        for i, a in enumerate(audios):
            sess = recorded_session(encode, params)
            if kind == "ctc":
                oracle = S.StreamingCTC(sess)
                oracle.push(a[None])
                want = [int(t) for t in oracle.finish(np.array([a.size]))[0]]
            else:
                oracle = S.StreamingTransducer(model, sess)
                oracle.push(a[None])
                toks, cnt = oracle.finish(np.array([a.size]))
                want = toks[0, :int(cnt[0])].tolist()
            mine, theirs = decoder.emitted_frames(f"s{i}"), sess.emitted_frames()
            check(mine.shape == theirs.shape, f"serve-slice {kind} s{i}: frames "
                  f"{tuple(mine.shape)} vs {tuple(theirs.shape)}")
            diff = (mine.float() - theirs.float()).abs().max().item()
            check(diff <= SERVE_FRAME_TOL[kind], f"serve-slice {kind} s{i}: server vs "
                  f"session |frames| {diff} > {SERVE_FRAME_TOL[kind]}")
            worst, peak = max(worst, diff), max(peak, theirs.float().abs().max().item())
            differ += got[f"s{i}"] != want
            if kind == "ctc":
                ties += near_ties(mine, theirs)
        say("serve-slice", decoder=kind, streams=len(audios), slots=SERVE_SLOTS,
            seconds=f"{SERVE_SECONDS[0]}-{SERVE_SECONDS[1]}", ticks=ticks, windows=len(outputs),
            tokens=sum(map(len, got.values())), max_frame_diff=f"{worst:.3g}",
            tol=SERVE_FRAME_TOL[kind], frame_max=f"{peak:.3g}", streams_differing=differ,
            near_tie_frames=ties if kind == "ctc" else "n/a", rel_launches=rel,
            tc_launches=rel_tc, bias_launches=bias, wall_s=f"{wall:.2f}",
            card=f"'{card_line}'")
    return launches, bias_launches, errs


def serve_rate_run(kind, model, params, max_windows):
    """serving_bench.py's workload: RATE_STREAMS streams of RATE_SECONDS,
    all submitted and pushed whole up front, admitted as slots free, run to
    the end once as a warm-up, then RATE_PASSES times more, each pass timed
    whole; then one pass in torch's sync debug mode and one profiled.
    Returns (tick seconds of the timed passes, each timed pass's wall
    seconds, syncs a tick, device ms of the profiled pass)."""
    from efficientconformer_torch import serving as SV

    if kind == "ctc":
        decoder = None
        encode = lambda a, n: model(a, n)[0].argmax(-1)     # noqa: E731, ids as serving_bench
    else:
        decoder, encode = SV.TransducerGreedyDecoder(model), model.encode
    srv = SV.StreamingServer(encode, params, num_slots=RATE_SLOTS, decoder=decoder,
                             max_windows_per_tick=max_windows, device="cuda", **SERVE_GEOMETRY)
    n = int(RATE_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(SEED).standard_normal(n) * 0.1).astype(np.float32)
    passes = iter(range(RATE_PASSES + 3))

    def one_pass():
        k = next(passes)
        for i in range(RATE_STREAMS):
            srv.submit(f"p{k}s{i}")
            srv.push(f"p{k}s{i}", audio)
            srv.end(f"p{k}s{i}", n)
        lat = []
        t0 = time.perf_counter()
        while srv.active_streams or srv.queued_streams:
            t1 = time.perf_counter()
            srv.tick()
            lat.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        check(len(srv._results) == (k + 1) * RATE_STREAMS, f"serve-rate pass {k} lost a stream")
        return lat, time.perf_counter() - t0

    one_pass()
    lat, walls = [], []
    for _ in range(RATE_PASSES):
        got, wall = one_pass()
        lat += got
        walls.append(wall)
    with count_syncs() as syncs:
        ticks = len(one_pass()[0])
    # the card's activity only: the device time is all this reads
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        one_pass()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    check(busy > 0, "serve-rate: the profiler saw no device time")
    return lat, walls, syncs["n"] / ticks, busy


def phase_serve_rate(card_line):
    """serving_bench.py's defaults (flagship, bf16, 32 slots, chunk 16,
    history 64, lookahead 4, 96 streams of 10 s) for both decoders (the
    Transducer on Transducer Small), max_windows_per_tick None and 2
    (serve_rate_run): the audio-s/s of each timed pass (median, min, max),
    tick p50/p95 over all their ticks, host syncs a tick, and the device
    time of a pass over the timed passes' median wall: the busy share.
    Returns the rel-pos and the bias launches of each run, by decoder and
    cap."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import bias_attention as BA

    launches = {}
    for kind in ("ctc", "transducer"):
        model = (make_model if kind == "ctc" else make_transducer)("cuda", torch.bfloat16)
        params = load_config(CONFIG if kind == "ctc" else T_CONFIG)["encoder_params"]
        for cap in (None, 2):
            reset_launch_counts()
            lat, walls, syncs, busy = serve_rate_run(kind, model, params, cap)
            rel, rel_tc = rel_counts()[:2]
            bias = BA.bias_attention.launches
            launches[f"{kind}-{cap}"] = rel, bias
            check(rel > 0 and rel_tc == rel and bias == 0, f"serve-rate {kind} cap {cap}: "
                  f"rel-pos launches {rel}, {rel_tc} on the tensor cores, bias launches {bias}")
            rates = RATE_STREAMS * RATE_SECONDS / np.array(walls)
            wall_ms = float(np.median(walls)) * 1e3
            ms = np.array(lat) * 1e3
            say("serve-rate", decoder=kind, max_windows_per_tick=cap, slots=RATE_SLOTS,
                streams=RATE_STREAMS, seconds=RATE_SECONDS, timed_passes=len(walls),
                timed_ticks=len(lat), audio_s_per_s=f"{np.median(rates):.1f}",
                audio_s_per_s_min=f"{rates.min():.1f}", audio_s_per_s_max=f"{rates.max():.1f}",
                tick_p50_ms=f"{np.percentile(ms, 50):.2f}",
                tick_p95_ms=f"{np.percentile(ms, 95):.2f}", syncs_per_tick=f"{syncs:.2f}",
                device_ms_per_pass=f"{busy:.1f}", wall_ms_per_pass=f"{wall_ms:.1f}",
                idle_share=f"{1 - busy / wall_ms:.3f}", rel_launches=rel, bias_launches=bias,
                card=f"'{card_line}'")
    return ({key: rel for key, (rel, _) in launches.items()},
            {key: bias for key, (_, bias) in launches.items()})


def phase_cli_beam(tmp, ngram_paths):
    """test-clean without --gready through the CLI, each with the synthetic
    6-gram at the redirected ngram_path: CTC Small (-i 2 of [cli-train])
    and Transducer Small (-i 1 of [cli-transducer]) with --initial_epoch_lm
    1, the LM-Transformer checkpoint of [cli-lm]. Each prints its Beam
    Search WER, and its predictions are those of the device beam called
    directly on the same loader batches."""
    from efficientconformer_torch import runtime
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.data.datasets import LibriSpeechDataset
    from efficientconformer_torch.data.loader import AsrBatchLoader
    from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
    from efficientconformer_torch.decoding.ngram import try_load
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models.transducer import greedy_token_cap
    from efficientconformer_torch.training.trainer import Trainer

    results = {}
    for name, epoch, flags in (("ctc", 2, []), ("transducer", 1, ["--initial_epoch_lm", 1])):
        cfg = load_config(os.path.join(tmp, f"{name}.json"))
        dp = cfg["decoding_params"]
        dp["ngram_path"] = ngram_paths[cfg["tokenizer_params"]["vocab_size"]]
        dp["lm_config"] = os.path.join(tmp, "lm.json")
        cfg_path = os.path.join(tmp, f"{name}_beam.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        out = run_cli("-c", cfg_path, "-m", "test-clean", "-i", epoch, "--verbose_val", *flags)
        cli_s = time.perf_counter() - t0
        wer_line = re.search(r"Beam Search WER : ([\d.]+)%", out)
        check(wer_line is not None, f"[cli-beam] {name}: no Beam Search WER line")
        printed = [ast.literal_eval(block) for block in
                   re.findall(r"Predictions:\n (\[.*\])\n", out)]

        trainer = Trainer(cfg, device="cuda")
        trainer.load(os.path.join(cfg["training_params"]["callback_path"],
                                  f"checkpoints_{epoch}.ckpt"))
        model = trainer.model.eval()
        tok = runtime.load_tokenizer(cfg)
        ngram = try_load(dp["ngram_path"], dp.get("ngram_offset", 100))
        lm = runtime.load_lm_for_fusion(cfg, 1, "cuda") if flags else None
        ds = LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"], "test-clean",
                                vocab_size=cfg["tokenizer_params"]["vocab_size"])
        direct = []
        for batch in AsrBatchLoader(ds, 8, shuffle=False, drop_last=False).epoch(0):
            audio = torch.from_numpy(batch["audio"][0]).cuda()
            audio_len = torch.from_numpy(batch["audio_len"][0]).cuda()
            with torch.inference_mode():
                if name == "ctc":
                    logits, n = model(audio, audio_len)
                    lists = ctc_beam_search_device(
                        torch.log_softmax(logits.float() / dp["tmp"], dim=-1), n,
                        dp["beam_size"], ngram=ngram, alpha=dp["ngram_alpha"],
                        beta=dp["ngram_beta"])
                else:
                    lists = beam_search_device(
                        model, audio, audio_len, beam_size=dp["beam_size"], tmp=dp["tmp"],
                        max_tokens=greedy_token_cap(cfg["encoder_params"], audio.shape[1],
                                                    MAX_CONSEC),
                        lm_model=lm["model"], lm_weight=lm["weight"], lm_tmp=lm["tmp"],
                        ngram=ngram, ngram_alpha=dp["ngram_alpha"],
                        ngram_beta=dp["ngram_beta"])
            direct.append(tok.decode(lists))
        check(printed == direct, f"[cli-beam] {name}: the CLI's predictions differ from the "
              "beam's")
        results[name] = (float(wer_line.group(1)), cli_s, sum(map(len, direct)))
    say("cli-beam", **{f"{k}_wer": f"{v[0]:.2f}" for k, v in results.items()},
        **{f"{k}_seconds": f"{v[1]:.2f}" for k, v in results.items()},
        utterances=results["ctc"][2], predictions_equal=True)


def phase_cli(card_line, train_rate_ms, ngram_paths) -> tuple:
    """The CLI phases in a temporary directory under build/ (removed after).
    Every kernel's launches on the CLI's path (all_counts' order): the sum
    over the CLI's runs, each counted from 0 (run_cli); the launches of
    the checks made outside a run do not count."""
    import tempfile

    os.makedirs("build", exist_ok=True)
    CLI_LAUNCHES[:] = [0] * len(CLI_LAUNCHES)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir="build", prefix="cli_smoke_") as tmp:
        phase_cli_data(tmp)
        cfg_path, cfg, saves, cli_ms = phase_cli_train(tmp, card_line, train_rate_ms)
        phase_cli_buckets(card_line)
        phase_cli_resume(cfg_path, cfg, saves, cli_ms)
        phase_cli_test(cfg_path, cfg)
        phase_cli_dp(tmp)
        phase_cli_import(tmp, cfg)
        phase_cli_swa(cfg_path, cfg)
        phase_cli_eval_time(cfg_path)
        phase_cli_profiler(cfg_path, cfg)
        phase_cli_transducer(tmp, card_line)
        phase_cli_lm(tmp, card_line)
        phase_cli_beam(tmp, ngram_paths)
    counts = tuple(CLI_LAUNCHES)
    say("cli", seconds=f"{time.perf_counter() - t0:.2f}", launches=counts)
    return counts


# ---------------------------------------------------------------- InterCTC


def interctc_config(**training) -> dict:
    """The flagship as an InterCTC model with taps after blocks INTERCTC_TAPS
    (the strided block 4 closing stage 1, and block 7 inside stage 2, ahead
    of the stride of block 9, so its probabilities hold twice the final
    frames), its training_params updated by ``training``."""
    cfg = train_config(**training)
    cfg["model_type"] = "InterCTC"
    cfg["encoder_params"]["interctc_blocks"] = list(INTERCTC_TAPS)
    return cfg


def phase_interctc_step(card_line, train_rate_ms):
    """One fp32 InterCTC step (as [train-slice]'s: 2 x 4 ragged utterances,
    dropout 0, SpecAugment off; one block a stage at full width, the taps
    INTERCTC_CUT_TAPS) through the kernels vs the plain
    versions on the card and vs the CPU; then the config's own bf16 step at
    [train-rate]'s 2 x 32 x 16 s: ms a step beside [train-rate]'s, the
    rel-pos launches of one step, all on the tensor cores, and the device
    ms and host syncs of a step beside the CTC config's on the same batch."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = interctc_config(mixed_precision=False)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    cfg["encoder_params"] = dict(one_block_a_stage(cfg["encoder_params"]),
                                 interctc_blocks=list(INTERCTC_CUT_TAPS))
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED + 44))
    reset_rel_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    fwd, fwd_tc, bwd, bwd_tc = rel_counts()
    n_cut = cfg["encoder_params"]["num_blocks"]
    n_att = n_cut * 2
    check(fwd == n_att and bwd == n_att and fwd_tc == bwd_tc == 0,
          f"[interctc-step] fp32 launches {rel_counts()}, expected {n_att} each on the FMA route")
    out = compare_steps(kernel, cfg, batch)

    cfg = interctc_config()
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    big = train_batch(tp["accumulated_steps"], tp["batch_size"],
                      tp["train_audio_max_length"] / SAMPLE_RATE, [80], "cuda",
                      np.random.default_rng(SEED + 4))
    trainer.train_step(big)
    torch.cuda.synchronize()
    reset_rel_counts()
    trainer.train_step(big)
    torch.cuda.synchronize()
    launches = rel_counts()
    n_att = cfg["encoder_params"]["num_blocks"] * tp["accumulated_steps"]
    check(launches == (n_att, n_att, n_att, n_att),
          f"[interctc-step] bf16 launches {launches}, expected {n_att} each on the tensor cores")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(big)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    # device ms and host syncs a step, beside the CTC config's own step on
    # the same batch: the wall clock of one step varies more between calls
    # than the taps cost
    ctc, _ = rate_trainer()
    device, syncs = {}, {}
    for name, tr in (("ctc", ctc), ("interctc", trainer)):
        tr.train_step(big)
        torch.cuda.synchronize()
        with count_syncs() as box:
            tr.train_step(big)
            torch.cuda.synchronize()
        syncs[name] = box["n"]
        device[name] = device_ms(lambda tr=tr: tr.train_step(big), 2)[0]
    say("interctc-step", config="EfficientConformerCTCSmall+InterCTC", taps=INTERCTC_TAPS,
        fp32_check_taps=INTERCTC_CUT_TAPS, fp32_check_blocks=n_cut,
        interctc_lambda=tp.get("interctc_lambda", 0.5), fp32_loss=f"{kernel[0]:.6f}", **out,
        bf16_ms_per_step=f"{dt * 1e3:.2f}", train_rate_ms_per_step=f"{train_rate_ms:.2f}",
        device_ms_per_step=f"{device['interctc']:.2f}",
        ctc_device_ms_per_step=f"{device['ctc']:.2f}", syncs_per_step=syncs["interctc"],
        ctc_syncs_per_step=syncs["ctc"], bf16_loss=f"{float(loss):.4f}",
        launches=launches[::2], tc_launches=launches[1::2], card=f"'{card_line}'")
    return launches[0], launches[2]


# ---------------------------------------------------------------- remat


def remat_step(cfg, batch, remat):
    """One step of a fresh trainer over ``cfg`` with encoder_params remat
    ``remat`` (None: off): (loss, grad norm, gradients on the CPU, BatchNorm
    statistics on the CPU, the generator's state after the step)."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = json.loads(json.dumps(cfg))
    if remat:
        cfg["encoder_params"]["remat"] = remat
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    loss, grad_norm = trainer.train_step(batch)
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers() if "running" in n}
    return float(loss), float(grad_norm), grads, stats, trainer.generator.get_state()


def phase_remat(card_line):
    """Activation recomputation on the flagship. fp32 at [train-slice]'s
    shape with its config's dropout 0.1 and SpecAugment on: remat "full"
    and "dots" give the step without remat (loss, gradients and BatchNorm
    statistics within REMAT_FP32_TOL relative, the generator's state equal,
    so the recompute drew the forward's masks and updated no statistic
    twice). Then the config's own bf16 step at [train-rate]'s 2 x 32 x 16 s
    with remat off, "full" and "dots": the three steps from the same
    weights within REMAT_BF16_TOL of each other (loss, gradients, BatchNorm
    statistics; the generator's state equal), then ms a step, peak
    memory and rel-pos launches a step for each (twice the forward's: the
    recompute runs the kernel again). Returns the rel-pos (forward,
    backward) launches of one remat "full" bf16 step."""
    cfg = train_config(mixed_precision=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED + 50))
    base = remat_step(cfg, batch, None)
    out = {}
    for remat in ("full", "dots"):
        got = remat_step(cfg, batch, remat)
        loss_err = abs(got[0] - base[0]) / abs(base[0])
        grad_err, stats_err = rel_diff(got[2], base[2]), rel_diff(got[3], base[3])
        same_gen = torch.equal(got[4], base[4])
        check(loss_err <= REMAT_FP32_TOL and grad_err <= REMAT_FP32_TOL
              and stats_err <= REMAT_FP32_TOL and same_gen,
              f"[remat] fp32 {remat}: loss {loss_err}, gradients {grad_err}, statistics "
              f"{stats_err}, generator state equal {same_gen}")
        out[remat] = (loss_err, grad_err, stats_err)
    say("remat-fp32", config="EfficientConformerCTCSmall", dropout=cfg["encoder_params"]["Pdrop"],
        spec_augment=cfg["encoder_params"]["spec_augment"],
        **{f"{r}_{k}": f"{v:.3g}" for r, errs in out.items()
           for k, v in zip(("loss_rel", "grad_rel", "stats_rel"), errs)},
        generator_state_equal=True, tol=REMAT_FP32_TOL)

    cfg = train_config()
    tp = cfg["training_params"]
    big = train_batch(tp["accumulated_steps"], tp["batch_size"],
                      tp["train_audio_max_length"] / SAMPLE_RATE, [80], "cuda",
                      np.random.default_rng(SEED + 4))
    first = {}
    full_launches = (0, 0)
    for remat in (None, "full", "dots"):
        first[remat] = remat_step(cfg, big, remat)
        if remat:
            b = first[None]
            loss_err = abs(first[remat][0] - b[0]) / abs(b[0])
            grad_err = rel_diff(first[remat][2], b[2])
            stats_err = rel_diff(first[remat][3], b[3])
            check(loss_err <= REMAT_BF16_TOL and grad_err <= REMAT_BF16_TOL
                  and stats_err <= REMAT_BF16_TOL and torch.equal(first[remat][4], b[4]),
                  f"[remat] bf16 {remat}: loss {loss_err}, gradients {grad_err}, statistics "
                  f"{stats_err}, generator state equal {torch.equal(first[remat][4], b[4])}")
        from efficientconformer_torch.training.trainer import Trainer

        c = json.loads(json.dumps(cfg))
        if remat:
            c["encoder_params"]["remat"] = remat
        trainer = Trainer(c, device="cuda", seed=SEED)
        trainer.train_step(big)
        torch.cuda.synchronize()
        reset_rel_counts()
        trainer.train_step(big)
        torch.cuda.synchronize()
        launches = rel_counts()
        if remat == "full":
            full_launches = (launches[0], launches[2])
        torch.cuda.reset_peak_memory_stats()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            loss, _ = trainer.train_step(big)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(math.isfinite(float(loss)), f"[remat] {remat}: loss {float(loss)}")
        errs = {} if not remat else {
            "loss_rel_vs_off": f"{abs(first[remat][0] - first[None][0]) / abs(first[None][0]):.3g}",
            "grad_rel_vs_off": f"{rel_diff(first[remat][2], first[None][2]):.3g}",
            "stats_rel_vs_off": f"{rel_diff(first[remat][3], first[None][3]):.3g}",
            "generator_state_equal": torch.equal(first[remat][4], first[None][4])}
        say("remat", config="EfficientConformerCTCSmall", remat=remat or "off",
            microbatches=tp["accumulated_steps"], batch=tp["batch_size"], seconds=16.0,
            dtype="bfloat16", ms_per_step=f"{dt * 1e3:.2f}", peak_mem_gib=f"{peak:.2f}",
            rel_fwd_launches=launches[0], rel_bwd_launches=launches[2],
            tc_launches=(launches[1], launches[3]), **errs, tol=REMAT_BF16_TOL,
            card=f"'{card_line}'")
        del trainer
        torch.cuda.empty_cache()
    return full_launches


# ---------------------------------------------------------------- variants


def variant_configs():
    """(name, encoder_params) of EfficientConformer CTC Small's widths, one
    block a stage (one_block_a_stage), with one change each (G 1 where
    local or strided attention, which the grouped layers do not take, is
    asked for)."""
    from efficientconformer_torch.config import load_config

    base = one_block_a_stage(load_config(CONFIG)["encoder_params"])
    return [
        ("att_group_size_2", dict(base, att_group_size=[2, 1, 1])),
        ("att_kernel_size_8", dict(base, att_group_size=1, att_kernel_size=8)),
        ("att_stride_2", dict(base, att_group_size=1, conv_stride=1, att_stride=2)),
        ("relative_pos_enc_false", dict(base, relative_pos_enc=False)),
        ("linear_att", dict(base, relative_pos_enc=False, linear_att=True)),
        ("subsampling_Conv1d", dict(base, subsampling_module="Conv1d",
                                    subsampling_filters=[240])),
        ("subsampling_Conv2dPool", dict(base, subsampling_module="Conv2dPool")),
        ("subsampling_VGG", dict(base, subsampling_module="VGG")),
    ]


def conformer_decoder_params(t_cfg) -> dict:
    """Transducer Small's prediction network as a Conformer decoder at its
    width (320), 2 blocks of 4 heads, kernel 15, ff_ratio 4."""
    return {"arch": "Conformer", "num_blocks": 2, "dim_model": t_cfg["decoder_params"]["dim_model"],
            "ff_ratio": 4, "num_heads": 4, "kernel_size": 15, "Pdrop": 0.1,
            "relative_pos_enc": True, "max_pos_encoding": 10000,
            "vocab_size": t_cfg["decoder_params"]["vocab_size"]}


def variant_forward(model, x, x_len):
    with torch.inference_mode():
        return model(x, x_len)[0].float().cpu()


def attention_blocks(p) -> tuple[int, int]:
    """(bias-kernel layers, rel-pos-kernel layers) of a full-context encoder
    ``p`` under its key mask: absolute attention, and rel-pos attention with
    an even G or a stride, take the bias kernel; the other rel-pos layers
    the factorized rel-pos kernel; local and linear attention neither."""
    from efficientconformer_torch.config import resolve_block_configs

    bias = rel = 0
    for c in resolve_block_configs(p):
        if c.linear_att or c.att_kernel_size is not None:
            continue
        if not c.relative_pos_enc or c.att_group_size % 2 == 0 or c.att_stride > 1:
            bias += 1
        else:
            rel += 1
    return bias, rel


def phase_variants(card_line):
    """The configs the JAX package builds from encoder_params and
    decoder_params that no shipped config uses: CTC Small with one change
    each (variant_configs), fp32, one forward of 4 ragged utterances of 4-8
    s through the kernels vs the plain versions on the card and vs the CPU
    (logits within SLICE_TOL); for the variants on the bias kernels also
    one fp32 training step (2 x 4 utterances, dropout 0, SpecAugment off)
    vs the plain versions on the card, and a bf16 forward on the
    tensor-core route vs the plain versions on the same bf16 model (logits
    within VARIANT_BF16_TOL). Then Transducer Small with a Conformer
    decoder: the lattice likewise (bf16 too), a training step, greedy
    tokens through the kernels equal to those through the plain versions,
    the device beam, and the greedy loop's ms a decoder step beside
    Transducer Small's RNN decoder on the same frames. Bias launches on
    each route are printed. Returns the bias forward and
    backward launches over the variants' fp32 training steps."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.models import transducer as T
    from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_

    rng = np.random.default_rng(SEED + 60)
    x, x_len = ragged_audio((8.0, 6.5, 4.0, 5.5), "cpu", rng)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED + 61))
    vocab = load_config(CONFIG)["tokenizer_params"]["vocab_size"]
    train_launches = [0, 0]
    for name, p in variant_configs():
        n_bias, n_rel = attention_blocks(p)
        model = ModelCTC(p, vocab)
        init_params_(model, torch.Generator().manual_seed(SEED))
        perturb_norms_(model.eval())
        want_cpu = variant_forward(model, x, x_len)
        model.cuda()
        reset_launch_counts()
        got = variant_forward(model, x.cuda(), x_len.cuda())
        fwd32 = (bias_launch_counts()[0], bias_tc_counts()[0])
        with plain_kernels():
            plain = variant_forward(model, x.cuda(), x_len.cuda())
        err_plain = (got - plain).abs().max().item()
        err_cpu = (got - want_cpu).abs().max().item()
        check(err_plain <= SLICE_TOL and err_cpu <= SLICE_TOL,
              f"[variants] {name}: logits vs plain {err_plain}, vs CPU {err_cpu} > {SLICE_TOL}")
        check(torch.isfinite(got).all().item(), f"[variants] {name}: non-finite logits")
        check(fwd32[0] == n_bias and fwd32[1] == 0 and rel_counts()[0] == n_rel,
              f"[variants] {name}: fp32 bias launches {fwd32}, rel-pos {rel_counts()[0]}")
        fields = {}
        if n_bias:
            cfg = train_config(mixed_precision=False)
            cfg["encoder_params"] = dict(p, Pdrop=0.0, spec_augment=False)
            reset_launch_counts()
            kernel = one_step(cfg, "cuda", batch)
            torch.cuda.synchronize()
            launches = bias_launch_counts()
            train_launches[0] += launches[0]
            train_launches[1] += launches[1]
            plain_step = one_step(cfg, "cuda", batch, plain=True)
            loss_err = abs(kernel[0] - plain_step[0]) / abs(plain_step[0])
            grad_err = rel_diff(kernel[2], plain_step[2])
            check(loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL,
                  f"[variants] {name} step: loss {loss_err}, gradients {grad_err}")
            check(launches[0] == launches[1] == 2 * n_bias,
                  f"[variants] {name} step: bias launches {launches}")
            model16 = ctc_model(p, torch.bfloat16)
            reset_launch_counts()
            out16 = variant_forward(model16, x.cuda(), x_len.cuda())
            tc16 = bias_tc_counts()[0]
            check(torch.isfinite(out16).all().item() and tc16 == bias_launch_counts()[0] == n_bias,
                  f"[variants] {name} bf16: tensor-core launches {bias_tc_counts()}")
            with plain_kernels():
                plain16 = variant_forward(model16, x.cuda(), x_len.cuda())
            err16, rel16 = bf16_logits_err(out16, plain16)
            check(rel16 <= VARIANT_BF16_TOL,
                  f"[variants] {name} bf16: logits vs plain {rel16} > {VARIANT_BF16_TOL}")
            fields = {"step_loss_rel": f"{loss_err:.3g}", "step_grad_rel": f"{grad_err:.3g}",
                      "step_bias_launches": launches, "bf16_tc_launches": tc16,
                      "bf16_vs_plain": f"{err16:.3g}", "bf16_vs_plain_rel": f"{rel16:.3g}",
                      "bf16_tol": VARIANT_BF16_TOL,
                      "bf16_vs_fp32": f"{(out16 - got).abs().max().item():.3g}"}
            del model16
        say("variants", config=name, dtype="float32", B=4, vs_plain=f"{err_plain:.3g}",
            vs_cpu=f"{err_cpu:.3g}", tol=SLICE_TOL, fp32_bias_launches=fwd32[0],
            rel_launches=rel_counts()[0], **fields)
        del model
        torch.cuda.empty_cache()

    # Transducer Small with a Conformer decoder
    t_cfg = load_config(T_CONFIG)
    dec = conformer_decoder_params(t_cfg)
    enc = t_cfg["encoder_params"]
    model = T.Transducer(enc, dec, t_cfg["joint_params"], dec["vocab_size"])
    init_params_(model, torch.Generator().manual_seed(SEED))
    perturb_norms_(model.eval())
    y = torch.from_numpy(np.random.default_rng(SEED + 62).integers(1, dec["vocab_size"], (4, 20)))
    y_len = torch.tensor([20, 12, 7, 16])
    y = y * (torch.arange(20)[None] < y_len[:, None])
    with torch.inference_mode():
        want_cpu = model(x, y, x_len, y_len)[0].float()
    model.cuda()
    reset_launch_counts()
    with torch.inference_mode():
        got = model(x.cuda(), y.cuda(), x_len.cuda(), y_len.cuda())[0].float().cpu()
        fwd32 = bias_launch_counts()[0]
        with plain_kernels():
            plain = model(x.cuda(), y.cuda(), x_len.cuda(), y_len.cuda())[0].float().cpu()
    err_plain, err_cpu = (got - plain).abs().max().item(), (got - want_cpu).abs().max().item()
    check(err_plain <= SLICE_TOL and err_cpu <= SLICE_TOL,
          f"[variants] conformer decoder lattice vs plain {err_plain}, vs CPU {err_cpu}")
    check(fwd32 == dec["num_blocks"], f"[variants] conformer decoder: bias launches {fwd32}")
    bf16 = {"compute_dtype": "bfloat16"}
    model16 = T.Transducer(dict(enc, **bf16), dict(dec, **bf16),
                           dict(t_cfg["joint_params"], **bf16), dec["vocab_size"])
    init_params_(model16, torch.Generator().manual_seed(SEED))
    perturb_norms_(model16.cuda().eval())
    reset_launch_counts()
    with torch.inference_mode():
        got16 = model16(x.cuda(), y.cuda(), x_len.cuda(), y_len.cuda())[0].float()
        tc16 = bias_tc_counts()[0]
        with plain_kernels():
            plain16 = model16(x.cuda(), y.cuda(), x_len.cuda(), y_len.cuda())[0].float()
    err16, rel16 = bf16_logits_err(got16, plain16)
    check(torch.isfinite(got16).all().item() and tc16 == dec["num_blocks"]
          and rel16 <= VARIANT_BF16_TOL,
          f"[variants] conformer decoder bf16: lattice vs plain {rel16}, tensor-core launches {tc16}")
    del model16, got16, plain16
    cap = T.greedy_token_cap(enc, int(x_len.max()), MAX_CONSEC)
    short = (x[:2, :int(2.5 * SAMPLE_RATE)].cuda(), torch.full((2,), int(2.5 * SAMPLE_RATE),
                                                             device="cuda"))
    short_cap = T.greedy_token_cap(enc, int(2.5 * SAMPLE_RATE), MAX_CONSEC)
    reset_launch_counts()
    tokens, counts = T.greedy_decode(model, *short, short_cap)
    greedy_launches = bias_launch_counts()[0]
    with plain_kernels():
        want_tok, want_n = T.greedy_decode(model, *short, short_cap)
    check(torch.equal(tokens, want_tok) and torch.equal(counts, want_n),
          "[variants] conformer decoder: greedy tokens through the kernels differ from plain")
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device

    beam = beam_search_device(model, *short, beam_size=4, max_tokens=short_cap)
    check(len(beam) == 2, "[variants] conformer decoder: beam")
    # the greedy loop's ms a decoder step, beside Transducer Small's own RNN
    # decoder on the same frames
    rnn = T.Transducer(enc, t_cfg["decoder_params"], t_cfg["joint_params"], dec["vocab_size"])
    init_params_(rnn, torch.Generator().manual_seed(SEED))
    rnn.encoder = model.encoder
    step_ms = {name: greedy_step_ms(m, x.cuda(), x_len.cuda(), cap)
               for name, m in (("conformer", model), ("rnn", rnn.cuda().eval()))}
    del rnn
    cfg = json.loads(json.dumps(t_cfg))
    cfg["decoder_params"] = dict(dec, Pdrop=0.0)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    cfg["training_params"].update(mixed_precision=False)
    t_batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED + 63))
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", t_batch)
    torch.cuda.synchronize()
    step_launches = bias_launch_counts()
    plain_step = one_step(cfg, "cuda", t_batch, plain=True)
    loss_err = abs(kernel[0] - plain_step[0]) / abs(plain_step[0])
    grad_err = rel_diff(kernel[2], plain_step[2])
    check(loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL,
          f"[variants] conformer decoder step: loss {loss_err}, gradients {grad_err}")
    train_launches[0] += step_launches[0]
    train_launches[1] += step_launches[1]
    say("variants", config="transducer_conformer_decoder", decoder=dec, dtype="float32", B=4,
        lattice_vs_plain=f"{err_plain:.3g}", lattice_vs_cpu=f"{err_cpu:.3g}", tol=SLICE_TOL,
        lattice_bias_launches=fwd32, lattice_bf16_vs_plain=f"{err16:.3g}",
        lattice_bf16_vs_plain_rel=f"{rel16:.3g}",
        lattice_bf16_tc_launches=tc16, bf16_tol=VARIANT_BF16_TOL, greedy_tokens=counts.tolist(),
        greedy_bias_launches=greedy_launches, beam_tokens=[len(b) for b in beam],
        step_loss_rel=f"{loss_err:.3g}", step_grad_rel=f"{grad_err:.3g}",
        step_bias_launches=step_launches, token_cap=cap, card=f"'{card_line}'")
    for name, (ms, steps, tokens) in step_ms.items():
        say("variants-greedy", decoder=name, B=4, seconds="8.0/6.5/4.0/5.5", dtype="float32",
            token_cap=cap, tokens=tokens, decoder_steps=steps, ms=f"{ms:.2f}",
            ms_per_step=f"{ms / steps:.3f}", card=f"'{card_line}'")
    return tuple(train_launches)


def bf16_logits_err(got, want) -> tuple[float, float]:
    """max |got - want| of two logit tensors, and the same over
    max(max |want|, 1)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1.0)


def greedy_step_ms(model, x, x_len, cap):
    """(ms, decoder steps, tokens) of the label-looping greedy loop over
    the encoder frames of x (T.decode_frames, the encoder outside the
    timing), after a warm-up run of the same loop."""
    from efficientconformer_torch.models import transducer as T

    calls = [0]
    step = model.decoder.step

    def counted(*args):
        calls[0] += 1
        return step(*args)

    with torch.inference_mode():
        f, f_len = model.encoder(x, x_len)
        model.decoder.step = counted
        try:
            T.decode_frames(model, f, f_len, cap, MAX_CONSEC)
            torch.cuda.synchronize()
            calls[0] = 0
            t0 = time.perf_counter()
            _, counts = T.decode_frames(model, f, f_len, cap, MAX_CONSEC)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            del model.decoder.step
    return ms, calls[0], counts.tolist()


# ------------------------------------------------------------ wide kernels


def phase_wide_kernel():
    """Both bias kernels vs their plain versions at head widths 135 (the
    causal EfficientConformer Medium/Large's stage 1) and 256, fp32 and
    bf16 (on the tensor cores, by the route counters), at Medium's stage-1
    window shape: 32 slots, H 4, N the grouped frames of a serving window
    (history 64, chunk 16, lookahead 4) with its causal bias. Then each
    timed in bf16 from CUDA graphs beside the plain version, SDPA with the
    bias as its mask (on inputs zero-padded to a multiple of 8 columns) and
    the bound. Returns the largest fp32 errors and the width-135 rows."""
    from efficientconformer_torch import streaming as S
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import bias_attention as BA

    p = dict(load_config(MEDIUM_CONFIG)["encoder_params"], causal=True, left_context=STREAM_LEFT)
    geo = S.WindowGeometry(p, **SERVE_GEOMETRY)
    frames, g, dh = stream_stage_shapes(p, geo.window_frames)[0]
    check(dh == 135, f"[wide-kernel] Medium's stage-1 head width is {dh}")
    h = p["num_heads"]
    gen = torch.Generator().manual_seed(SEED + 70)
    err_f = err_b = 0.0
    rows = {}
    for width in (135, 256):
        lengths = torch.linspace(1, frames, STREAM_SLOTS).round().long()
        bias, _ = stream_bias(STREAM_SLOTS, h, frames, g, STREAM_LEFT, 0, lengths, gen)
        n = bias.shape[-1]
        args = bias_inputs(STREAM_SLOTS, h, n, n, width, width, "keymask", gen)
        args = (*args[:3], bias.cuda(), args[4])
        ef, eb = check_bias_case(f"width-{width}", args, gen, phase="wide-kernel")
        err_f, err_b = max(err_f, ef), max(err_b, eb)
        q, k, v, bias, scale = args
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
        do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
        mask16 = bias.to(torch.bfloat16)
        lq, lk, lv = (pad8(t).detach().requires_grad_() for t in (q, k, v))
        lmask = mask16.detach().clone().requires_grad_()
        ldo = pad8(do)

        def library_fwd():
            return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask16, scale=scale)

        def library_bwd():
            out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask, scale=scale)
            return torch.autograd.grad(out, (lq, lk, lv, lmask), ldo)

        calls = {"forward": {
            "kernel": lambda: BA.bias_attention_fwd(q, k, v, bias, scale),
            "plain": lambda: BA.reference_bias_attention(q, k, v, bias, scale),
            "library": library_fwd}, "backward": {
            "kernel": lambda: BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale),
            "plain": lambda: BA.reference_bias_attention_bwd(q, k, v, bias, do, scale),
            "library": library_bwd}}
        for label, fns in calls.items():
            backward = label == "backward"
            row = {name: graph_ms(fn) for name, fn in fns.items()}
            row["bound"], row["bound_by"] = bound(*bias_cost(STREAM_SLOTS, h, n, n, width,
                                                             width, 2, backward))
            say("wide-kernel-time", direction=label, B=STREAM_SLOTS, H=h, N=n, dh=width,
                dtype="bfloat16", bound_by=row["bound_by"],
                library="sdpa fwd" + (" + bwd, mask grad" if backward else "") + ", bias as mask",
                **{f"{k}_ms": f"{v:.4f}" for k, v in row.items() if k != "bound_by"})
            rows[(width, label)] = row
    return err_f, err_b, rows


# ---------------------------------------------------------------- Medium streamed


def phase_stream_medium():
    """EfficientConformerCTCMedium at its published widths and depth made
    causal (left context STREAM_EXACT_LEFT), streamed in fp32 as
    [stream-exact] streams the flagship (stream_exact_case): its stage-1
    layers run the bias kernels at head width 135. Returns its bias
    launches and the largest fp32 kernel error."""
    from efficientconformer_torch.config import load_config

    p = dict(load_config(MEDIUM_CONFIG)["encoder_params"], causal=True,
             left_context=STREAM_EXACT_LEFT)
    launches, rel, err = stream_exact_case("stream-medium", "medium-causal", p, (60.0, 50.0),
                                           np.random.default_rng(SEED + 80),
                                           torch.Generator().manual_seed(SEED + 81))
    return launches, err


def wall_ms(fn, iters: int = 3) -> float:
    """Host-clock ms per call of ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int) -> tuple[float, list]:
    """(device ms per call, the profiler's rows of device time by kernel)
    over ``iters`` calls of ``fn``. User-annotation ranges (the
    optimizer's) are left out, since the kernels inside them count
    already."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sum(e.self_device_time_total for e in rows) / 1e3 / iters, rows


def profile(label: str, fn, wall: float, iters: int = 3) -> None:
    """Device time by kernel over ``iters`` calls of ``fn``, and the
    device's idle share: 1 - device time over ``wall``, the ms per call
    timed without any profiler (the profiler's own host cost, which lingers
    after a session, would inflate it)."""
    busy, rows = device_ms(fn, iters)
    say(f"profile-{label}", iters=iters, device_ms=f"{busy:.3f}", wall_ms=f"{wall:.3f}",
        idle_share=f"{1 - busy / wall:.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:25]:
        ms = e.self_device_time_total / 1e3 / iters
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{e.count // iters:<5d} {e.key[:110]}",
              flush=True)


# ------------------------------------------------------ wide fp32 rel-pos


def wide_fp32_shapes():
    """{(N, dh, D, H, G): [config names]} of the 16 s stage shapes of the
    shipped ASR configs past the flagship's widths on the fp32 route: a
    head wider than 128 or dh + D over 416 (EfficientConformer Medium and
    Large, CTC and Transducer, and Conformer Large)."""
    from efficientconformer_torch.config import load_config

    out = {}
    for path in ASR_CONFIGS:
        for _, n, dh, d, h, g in stage_shapes(load_config(path)["encoder_params"], TRAIN_SECONDS):
            if dh > 128 or dh + d > 416:
                out.setdefault((n, dh, d, h, g), []).append(
                    path.split("/")[-1].removesuffix(".json"))
    return out


def sdpa_fp32_math(args, do):
    """(forward, forward and backward) of scaled_dot_product_attention's
    fp32 math path on [qu | A], [k | keytab] and v (A formed with plain
    torch, the key mask as an fp32 float mask): the library yardstick of
    the fp32 route, computed nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qa, ka, v, mask = augmented(args)
    mask = mask.float()
    lq, lk, lv = (t.detach().requires_grad_() for t in (qa, ka, v))
    ldo = pad8(do)

    def forward():
        with sdpa_kernel(SDPBackend.MATH):
            return F.scaled_dot_product_attention(qa, ka, v, attn_mask=mask, scale=args[8])

    def backward():
        with sdpa_kernel(SDPBackend.MATH):
            out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=args[8])
        return torch.autograd.grad(out, (lq, lk, lv), ldo)

    return forward, backward


def phase_wide_fp32_kernel():
    """Both rel-pos kernels on the fp32 FMA route at wide_fp32_shapes, B
    WIDE_FP32_BATCH at 16 s, vs the plain versions on the same inputs
    (forward within KERNEL_FP32_TOL, gradients within GRAD_TOL), each call
    counted on the fp32 route and none on the tensor cores. Then each timed
    from CUDA graphs as [kernel-time] times the flagship: the kernel, the
    bf16 route on the same inputs, SDPA's fp32 math path on the augmented
    features, the plain version per eager call, and the fp32 bound. Returns
    the largest forward error, the largest gradient error and the times
    summed over the shapes, by direction."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED + 80)
    err_f = err_b = 0.0
    times = {label: {"kernel": 0.0, "plain": 0.0, "bf16": 0.0, "library": 0.0, "bound": 0.0}
             for label in ("forward", "backward")}
    for (n, dh, d, h, g), configs in wide_fp32_shapes().items():
        b = WIDE_FP32_BATCH
        args = attention_inputs(b, n, dh, d, h, g, "cuda", gen)
        reset_rel_counts()
        o, lse = RA.relpos_attention_fwd(*args)
        o_p, lse_p = RA.reference_relpos_attention(*args)
        do = torch.randn(o.shape, generator=gen).cuda()
        got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
        want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
        torch.cuda.synchronize()
        check(rel_counts() == (1, 0, 1, 0), f"[wide-fp32-kernel] dh {dh} D {d}: route counts "
              f"{rel_counts()}, expected one launch a direction on the fp32 route")
        ef = max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item())
        eb = grad_errors(got, want)
        check(ef <= KERNEL_FP32_TOL, f"[wide-fp32-kernel] dh {dh} D {d}: forward {ef}")
        check(max(eb.values()) <= GRAD_TOL, f"[wide-fp32-kernel] dh {dh} D {d}: backward {eb}")
        err_f, err_b = max(err_f, ef), max(err_b, *eb.values())
        say("wide-fp32-kernel", configs=",".join(configs), B=b, N=n, dh=dh, D=d, H=h, G=g,
            fp32_err=f"{ef:.3g}", bwd_rel_err=f"{max(eb.values()):.3g}",
            fma_launches=rel_counts()[::2], tc_launches=rel_counts()[1::2], route="fma",
            fwd_kernel="resident" if RA.fma_resident(dh, d) else "streamed",
            tol=f"{KERNEL_FP32_TOL}/{GRAD_TOL}")

        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o16, lse16 = RA.relpos_attention_fwd(*args16)
        do16 = do.bfloat16()
        library_fwd, library_bwd = sdpa_fp32_math(args, do)
        calls = {"forward": {
            "kernel": lambda: RA.relpos_attention_fwd(*args),
            "bf16": lambda: RA.relpos_attention_fwd(*args16),
            "library": library_fwd}, "backward": {
            "kernel": lambda: RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8],
                                                      need_dbias=False),
            "bf16": lambda: RA.relpos_attention_bwd(*args16[:8], o16, do16, lse16, args[8],
                                                    need_dbias=False),
            "library": library_bwd}}
        plain = {"forward": lambda: RA.reference_relpos_attention(*args),
                 "backward": lambda: RA.reference_relpos_attention_bwd(*args[:8], do, lse,
                                                                       args[8])}
        for label, fns in calls.items():
            backward = label == "backward"
            row = {name: graph_ms(fn) for name, fn in fns.items()}
            row["plain"] = cuda_ms(plain[label])
            row["bound"], bound_by = bound(*attention_cost(b, n, dh, d, h, 4, backward),
                                           peak=FP32_PEAK)
            for key, value in row.items():
                times[label][key] += value
            times[label]["bound_by"] = bound_by
            say("wide-fp32-kernel-time", direction=label, configs=",".join(configs), B=b, N=n,
                dh=dh, D=d, H=h, G=g, dtype="float32", bound_by=bound_by,
                library="sdpa math fp32" + (" fwd+bwd" if backward else " fwd"),
                **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    return err_f, err_b, times


def phase_wide_fp32_slice(card_line):
    """One fp32 training step (mixed_precision false) of each of
    WIDE_FP32_CONFIGS at its published widths and depth, through the
    Trainer on WIDE_FP32_SECONDS of audio (dropout 0, SpecAugment off, VN
    off), against the same step through the plain versions on the card:
    loss within TRAIN_LOSS_RTOL, gradients within TRAIN_GRAD_TOL, BatchNorm
    statistics within TRAIN_STATS_TOL. Each encoder at one block a stage
    (one_block_a_stage). The gradient norm is held to
    TRAIN_LOSS_RTOL with the CTC or RNN-T loss in float64 on both sides
    (``float64_loss``): through the fp32 lattices (L ~700-1,400 nats at
    random weights) it moves with every change of the logits' rounding, and
    is printed beside it. Every
    rel-pos launch on the fp32 route: one a block a direction. Prints ms a
    step (a second step, warm), the first step's peak memory and the
    launches; returns the launches summed over the configs (rel-pos
    forward, backward, RNN-T alphas, gradients)."""
    from efficientconformer_torch.training.trainer import Trainer

    total = np.zeros(4, dtype=np.int64)
    for i, name in enumerate(WIDE_FP32_CONFIGS):
        path = f"configs/{name}.json"
        transducer = "Transducer" in name
        cfg = train_config(path, mixed_precision=False,
                           **({"vn_start_step": None} if transducer else {}))
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        published = cfg["encoder_params"]["num_blocks"]
        cfg["encoder_params"] = one_block_a_stage(cfg["encoder_params"])
        batch = train_batch(1, len(WIDE_FP32_SECONDS), [WIDE_FP32_SECONDS], [60, 30], "cpu",
                            np.random.default_rng(SEED + 90 + i))
        trainer = Trainer(cfg, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        loss, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        kernel = (float(loss), float(grad_norm),
                  {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()},
                  {n: b.cpu() for n, b in trainer.model.named_buffers() if "running" in n})
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        blocks = cfg["encoder_params"]["num_blocks"]
        del trainer
        torch.cuda.empty_cache()
        check(counts[2:] == (blocks, blocks) and rel_counts()[1::2] == (0, 0),
              f"[wide-fp32-slice] {name}: rel-pos launches {counts[2:]} (tensor cores "
              f"{rel_counts()[1::2]}), expected {blocks} / {blocks} on the fp32 route")
        check(not transducer or counts[:2] == (1, 2),
              f"[wide-fp32-slice] {name}: RNN-T launches {counts[:2]}, expected (1, 2)")
        plain = one_step(cfg, "cuda", batch, plain=True)
        with float64_loss():
            norm64 = [one_step(cfg, "cuda", batch, plain=p)[1] for p in (False, True)]
        loss_err = abs(kernel[0] - plain[0]) / abs(plain[0])
        norm_err = abs(kernel[1] - plain[1]) / abs(plain[1])
        norm64_err = abs(norm64[0] - norm64[1]) / abs(norm64[1])
        grad_err, stats_err = rel_diff(kernel[2], plain[2]), rel_diff(kernel[3], plain[3])
        check(loss_err <= TRAIN_LOSS_RTOL and math.isfinite(kernel[0]),
              f"[wide-fp32-slice] {name}: loss {kernel[0]} / {plain[0]}")
        check(grad_err <= TRAIN_GRAD_TOL and stats_err <= TRAIN_STATS_TOL,
              f"[wide-fp32-slice] {name}: gradients {grad_err}, statistics {stats_err}")
        check(norm64_err <= TRAIN_LOSS_RTOL,
              f"[wide-fp32-slice] {name}: gradient norm with the loss in float64 {norm64}")
        total += np.asarray(counts)[[2, 3, 0, 1]]
        say("wide-fp32-slice", config=name, dtype="float32", seconds=list(WIDE_FP32_SECONDS),
            blocks=blocks, published_blocks=published, loss=f"{kernel[0]:.6f}",
            grad_norm=f"{kernel[1]:.6f}",
            plain_loss_rel=f"{loss_err:.3g}", plain_norm_rel=f"{norm_err:.3g}",
            plain_norm_rel_float64_loss=f"{norm64_err:.3g}",
            plain_grad_rel=f"{grad_err:.3g}", plain_stats_rel=f"{stats_err:.3g}",
            ms_per_step=f"{ms:.2f}", peak_mem_gib=f"{peak:.3f}", rel_fwd_launches=counts[2],
            rel_bwd_launches=counts[3], rnnt_launches=counts[:2], route="fma",
            tol=f"{TRAIN_LOSS_RTOL}/{TRAIN_GRAD_TOL}", card=f"'{card_line}'")
        torch.cuda.empty_cache()
    return tuple(int(x) for x in total)


# ------------------------------------------------ the wide rel-pos routes


def wider_encoder(name: str) -> tuple[dict, dict]:
    """(config, encoder_params) of WIDER_MODELS[name]: the shipped config
    with its one field changed and its depth cut as the table says (the
    stride and expansion blocks kept at their places)."""
    from efficientconformer_torch.config import load_config

    base, change, blocks = WIDER_MODELS[name]
    cfg = load_config(f"configs/{base}.json")
    cfg["encoder_params"].update(change)
    if blocks is not None:
        cfg["encoder_params"]["num_blocks"] = blocks
    return cfg, cfg["encoder_params"]


def wider_shapes(gen):
    """[wider-kernel]'s cases, (label, args, (N, Nk, dh, D, H)): the 16 s
    stage shapes of WIDER_MODELS that reach a wide route in some type or
    direction (B WIDE_FP32_BATCH), WIDER_FREE_SHAPES, and the stage-1 shape
    of the first at seq rank 1 of 2: its query rows [Nk/2, Nk) against
    every key, as [sp-kernel] calls the kernels."""
    from efficientconformer_torch.ops import rel_attention as RA

    b = WIDE_FP32_BATCH
    cases = []
    for model in WIDER_MODELS:
        enc = wider_encoder(model)[1]
        for name, n, dh, d, h, g in stage_shapes(enc, TRAIN_SECONDS):
            if any(RA.is_wide(dt, dh, d, bw) for dt in (torch.float32, torch.bfloat16)
                   for bw in (False, True)):
                args = attention_inputs(b, n, dh, d, h, g, "cuda", gen)
                cases.append((f"{model}:{name}", args, (n, n, dh, d, h)))
                if not cases[1:] and g > 1:
                    r0 = n // 2
                    qu, rowtab = args[0][:, :, r0:].contiguous(), args[5][r0:]
                    cases.append((f"{model}:{name}:seq-rank-1-of-2",
                                  (qu, *args[1:5], rowtab, *args[6:]), (n - r0, n, dh, d, h)))
    for dh, d in WIDER_FREE_SHAPES:
        cases.append((f"free:{dh}/{d}",
                      attention_inputs(b, 201, dh, d, 4, 1, "cuda", gen, free_w=True),
                      (201, 201, dh, d, 4)))
    return cases


def phase_wider_kernel():
    """[wider-kernel]: both rel-pos kernels at wider_shapes, fp32 and bf16,
    vs the plain versions on the same inputs (fp32: forward within
    KERNEL_FP32_TOL, gradients within GRAD_TOL relative; bf16: the forward
    within KERNEL_BF16_TOL of the fp32 plain version on the same bf16 qu, k,
    v, gradients within GRAD_BF16_TOL relative, bitwise repeatable), each
    call counted on the route ``route`` names: the tensor cores for bf16,
    and a wide route wherever it names one. Then [wider-kernel-time]: each
    (type, direction) on a wide route timed from CUDA graphs beside the
    plain version (per eager call), SDPA on [qu | A], [k | keytab], v with A
    given (bf16: its memory-efficient kernel; fp32: its math path) and the
    bound. Returns (largest fp32 forward and gradient errors, largest bf16
    ones, the times summed by direction over the wide rows, and by route)."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED + 110)
    errs = {"fp32_fwd": 0.0, "fp32_bwd": 0.0, "bf16_fwd": 0.0, "bf16_bwd": 0.0}
    times = {label: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0,
                     "bound_ops": 0.0, "bound_bytes": 0.0, "tc_wide": 0.0, "fma_wide": 0.0}
             for label in ("forward", "backward")}
    for label, args, (n, nk, dh, d, h) in wider_shapes(gen):
        b = args[0].shape[0]
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dtype) for t in args[:3]] + list(args[3:])
            kinds = [RA.route(dtype, dh, d, bw) for bw in (False, True)]
            reset_rel_counts()
            o, lse = RA.relpos_attention_fwd(*a)
            o_p, lse_p = RA.reference_relpos_attention(*[t.float() for t in a[:3]], *a[3:])
            do = torch.randn(o.shape, generator=gen).to("cuda", dtype)
            got = RA.relpos_attention_bwd(*a[:8], o, do, lse, a[8])
            again = RA.relpos_attention_bwd(*a[:8], o, do, lse, a[8])
            want = RA.reference_relpos_attention_bwd(*a[:8], do, lse, a[8])
            torch.cuda.synchronize()
            tc = int(dtype == torch.bfloat16)
            wide = tuple(int(k.endswith("_wide")) * (1 + bw) for bw, k in enumerate(kinds))
            check(rel_counts() == (1, tc, 2, 2 * tc) and wide_counts() == wide,
                  f"[wider-kernel] {label} {dtype}: launches {rel_counts()}, wide "
                  f"{wide_counts()}, expected the routes {kinds}")
            ef = max((o.float() - o_p).abs().max().item(), (lse - lse_p).abs().max().item())
            eb = max(grad_errors(got, want).values())
            tol_f, tol_b = (KERNEL_FP32_TOL, GRAD_TOL) if not tc else (KERNEL_BF16_TOL,
                                                                       GRAD_BF16_TOL)
            check(ef <= tol_f and eb <= tol_b, f"[wider-kernel] {label} {dtype}: forward {ef} "
                  f"> {tol_f} or gradients {eb} > {tol_b}")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"[wider-kernel] {label} {dtype}: the backward is not bitwise repeatable")
            key = "bf16" if tc else "fp32"
            errs[f"{key}_fwd"], errs[f"{key}_bwd"] = (max(errs[f"{key}_fwd"], ef),
                                                      max(errs[f"{key}_bwd"], eb))
            row[key] = (ef, eb, kinds, a, o, lse, do)
        say("wider-kernel", case=label, B=b, N=n, Nk=nk, dh=dh, D=d, H=h,
            fp32_routes="/".join(row["fp32"][2]), bf16_routes="/".join(row["bf16"][2]),
            fp32_err=f"{row['fp32'][0]:.3g}", fp32_bwd_rel_err=f"{row['fp32'][1]:.3g}",
            bf16_err=f"{row['bf16'][0]:.3g}", bf16_bwd_rel_err=f"{row['bf16'][1]:.3g}",
            tol=f"{KERNEL_FP32_TOL}/{GRAD_TOL} fp32, {KERNEL_BF16_TOL}/{GRAD_BF16_TOL} bf16",
            bf16_repeatable="bitwise")

        for key, (_, _, kinds, a, o, lse, do) in row.items():
            tc = key == "bf16"
            if tc:
                library_fwd, _ = sdpa_yardstick(*augmented(a), a[8])
                qa, ka, v, mask = augmented(a)
                qa, ka, v = (t.detach().requires_grad_() for t in (qa, ka, v))
                library_bwd, _ = sdpa_yardstick(qa, ka, v, mask, a[8], pad8(do))
            else:
                library_fwd, library_bwd = sdpa_fp32_math(a, do)
            calls = {"forward": (lambda: RA.relpos_attention_fwd(*a), library_fwd,
                                 lambda: RA.reference_relpos_attention(*a)),
                     "backward": (lambda: RA.relpos_attention_bwd(*a[:8], o, do, lse, a[8],
                                                                  need_dbias=False),
                                  library_bwd,
                                  lambda: RA.reference_relpos_attention_bwd(*a[:8], do, lse,
                                                                            a[8]))}
            for bw, (direction, (kernel, library, plain)) in enumerate(calls.items()):
                if not kinds[bw].endswith("_wide"):
                    continue
                flops, nbytes = attention_cost(b, n, dh, d, h, 2 if tc else 4, bool(bw), nk=nk)
                peak = BF16_PEAK if tc else FP32_PEAK
                t = {"kernel": graph_ms(kernel, iters=10, replays=3),
                     "plain": cuda_ms(plain, iters=5, warmup=1),
                     "library": graph_ms(library, iters=10, replays=3)}
                t["bound"], bound_by = bound(flops, nbytes, peak=peak)
                for k, v in t.items():
                    times[direction][k] += v
                times[direction]["bound_ops"] += flops / peak * 1e3
                times[direction]["bound_bytes"] += nbytes / HBM_RATE * 1e3
                times[direction][kinds[bw]] += t["kernel"]
                say("wider-kernel-time", case=label, direction=direction, route=kinds[bw],
                    dtype=str(a[0].dtype).removeprefix("torch."), B=b, N=n, Nk=nk, dh=dh, D=d,
                    H=h, bound_by=bound_by, library="sdpa " + ("memory-efficient bf16" if tc
                                                               else "math fp32"),
                    **{f"{k}_ms": f"{v:.4f}" for k, v in t.items()})
    for t in times.values():
        t["bound_by"] = "operations" if t["bound_ops"] >= t["bound_bytes"] else "bytes"
    return errs, times


def expected_routes(enc_params: dict, dtype) -> tuple[int, int]:
    """(forward, backward) launches on a wide route in one pass of the
    encoder over ``enc_params``: its attention layers at their widths."""
    from efficientconformer_torch.config import resolve_block_configs
    from efficientconformer_torch.ops import rel_attention as RA

    shapes = [(b.att_group_size * b.dim_model // b.num_heads, b.dim_model)
              for b in resolve_block_configs(enc_params)]
    return tuple(sum(RA.is_wide(dtype, dh, d, bw) for dh, d in shapes) for bw in (False, True))


def grad_gap(got: dict, want: dict) -> float:
    """The gradients' relative L2 distance over every parameter, |got -
    want| / |want|."""
    num = sum(((got[k] - want[k]) ** 2).sum().item() for k in want)
    return math.sqrt(num / sum((want[k] ** 2).sum().item() for k in want))


def counted_step(cfg, batch, phase, name, dtype):
    """One step of a fresh Trainer over ``cfg`` through the kernels, its
    launches checked (a block a direction, all on the tensor cores in bf16
    and none there in fp32, the wide ones where ``route`` names them), and
    the same step through the plain versions on the card. The step's
    numbers and its comparison with the plain versions': loss, gradient
    norm, gradients (the largest of one parameter's, relative to its
    largest) and BatchNorm statistics, relative; both steps' results."""
    blocks = cfg["encoder_params"]["num_blocks"]
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    counts, wide, rnnt = rel_counts(), wide_counts(), launch_counts()[:2]
    tc = blocks if dtype == torch.bfloat16 else 0
    want = expected_routes(cfg["encoder_params"], dtype)
    check(counts == (blocks, tc, blocks, tc) and wide == want,
          f"[{phase}] {name} {dtype}: rel-pos launches {counts}, wide {wide}, expected "
          f"{blocks} a direction, {tc} on the tensor cores, {want} wide")
    plain = one_step(cfg, "cuda", batch, plain=True)
    check(cfg["model_type"] != "Transducer" or rnnt == (1, 2),
          f"[{phase}] {name} {dtype}: RNN-T launches {rnnt}, expected (1, 2)")
    out = {"loss": kernel[0], "grad_norm": kernel[1],
           "loss_rel": abs(kernel[0] - plain[0]) / abs(plain[0]),
           "norm_rel": abs(kernel[1] - plain[1]) / abs(plain[1]),
           "grad_rel": rel_diff(kernel[2], plain[2]), "stats_rel": rel_diff(kernel[3], plain[3]),
           "launches": counts[::2], "wide": wide, "kernel": kernel, "plain": plain}
    check(math.isfinite(kernel[0]), f"[{phase}] {name} {dtype}: loss {kernel[0]}")
    return out


def leaf_gap(got: dict, want: dict, ref: dict) -> tuple[float, str, int]:
    """The largest over the parameters of |got - ref| / |want - ref| (L2
    norms of one parameter's gradient; the denominator floored at
    BF16_LEAF_FLOOR |ref|), that parameter's name, and how many parameters
    were left out: those whose gradient ``ref`` is under BF16_LEAF_ZERO of
    one of RMS size (|ref|_all sqrt(n / n_all)), zero in exact arithmetic
    (the softmax and BatchNorm take no constant shift), rounding alone."""
    def l2(t):
        return t.double().norm().item()

    norms = {k: l2(ref[k]) for k in ref}
    rms = math.sqrt(sum(v * v for v in norms.values()) / sum(ref[k].numel() for k in ref))
    kept = [k for k in ref if norms[k] >= BF16_LEAF_ZERO * rms * math.sqrt(ref[k].numel())]
    ratios = {k: l2(got[k] - ref[k]) / max(l2(want[k] - ref[k]), BF16_LEAF_FLOOR * norms[k])
              for k in kept}
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst, len(ref) - len(kept)


def check_step(phase, name, dtype, out, fp32_grads=None):
    """The step against the plain versions' at the gates of its type. fp32:
    loss TRAIN_LOSS_RTOL, gradients TRAIN_GRAD_TOL, statistics
    TRAIN_STATS_TOL. bf16: loss, gradient norm and statistics within
    VARIANT_BF16_TOL; the gradients no farther from ``fp32_grads`` (the
    plain versions' fp32 step) than BF16_GRAD_NOISE x the plain versions'
    bf16 gradients are (grad_gap), and each parameter's no farther than
    BF16_LEAF_NOISE x the plain versions' bf16 gradient of it (leaf_gap,
    gradients zero but for rounding left out): a gradient's own bf16 noise
    through the model is larger than the kernels' gates, so it is the
    yardstick."""
    keys = ("loss_rel", "norm_rel", "grad_rel", "stats_rel")
    shown = {f"plain_{k}": f"{out[k]:.3g}" for k in keys}
    if dtype == torch.float32:
        tols = (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STATS_TOL)
        errs = (out["loss_rel"], out["grad_rel"], out["stats_rel"])
        check(all(e <= t for e, t in zip(errs, tols)),
              f"[{phase}] {name} {dtype}: loss / gradients / statistics {errs} > {tols}")
        return shown | {"tol": "/".join(map(str, tols))}
    errs = (out["loss_rel"], out["norm_rel"], out["stats_rel"])
    gaps = (grad_gap(out["kernel"][2], fp32_grads), grad_gap(out["plain"][2], fp32_grads))
    leaf, worst, zero = leaf_gap(out["kernel"][2], out["plain"][2], fp32_grads)
    check(all(e <= VARIANT_BF16_TOL for e in errs) and gaps[0] <= BF16_GRAD_NOISE * gaps[1]
          and leaf <= BF16_LEAF_NOISE,
          f"[{phase}] {name} bf16: loss / norm / statistics {errs} > {VARIANT_BF16_TOL}, or "
          f"gradients {gaps[0]} from the fp32 step's against the plain versions' {gaps[1]}, "
          f"or {worst}'s {leaf:.3g}x the plain versions' distance")
    return shown | {"grad_gap_fp32": f"{gaps[0]:.4g}", "plain_grad_gap_fp32": f"{gaps[1]:.4g}",
                    "leaf_gap": f"{leaf:.3g}", "leaf": worst, "leaves_zero": zero,
                    "tol": f"{VARIANT_BF16_TOL}, gap x{BF16_GRAD_NOISE}, leaf x{BF16_LEAF_NOISE}"}


def counted_inference(phase, name, model, enc_params, transducer=False):
    """One bf16 greedy batch (2 utterances of WIDE_FP32_SECONDS) through the
    kernels, counted, and the same through the plain versions on the card:
    CTC logits within VARIANT_BF16_TOL of the plain versions' relative to
    max(max|.|, 1), or the Transducer's encoder frames within
    SERVE_FRAME_TOL["transducer"] (max |diff|, [serve-slice]'s gate for the
    same frames); the rows whose tokens differ counted. Returns the
    forward's launches (all, wide)."""
    from efficientconformer_torch.models import transducer as T
    from efficientconformer_torch.models.model_ctc import greedy_decode

    x, x_len = ragged_audio(WIDE_FP32_SECONDS, "cuda", np.random.default_rng(SEED + 120))
    cap = T.greedy_token_cap(enc_params, x.shape[1], MAX_CONSEC) if transducer else None

    def decode():
        with torch.inference_mode():
            if transducer:
                return T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
            return greedy_decode(model, x, x_len)

    def frames():
        with torch.inference_mode():
            return (model.encoder if transducer else model)(x, x_len)[0]

    blocks = enc_params["num_blocks"]
    reset_rel_counts()
    tokens, counts = decode()
    torch.cuda.synchronize()
    launches, wide = rel_counts(), wide_counts()
    want = expected_routes(enc_params, torch.bfloat16)[0]
    check(launches[:2] == (blocks, blocks) and wide[0] == want,
          f"[{phase}] {name} greedy: launches {launches[:2]}, wide {wide[0]}, expected "
          f"{blocks} on the tensor cores, {want} wide")
    got = frames()
    with plain_kernels():
        want_frames = frames()
        p_tokens, p_counts = decode()
    err, rel = bf16_logits_err(got, want_frames)
    tol = SERVE_FRAME_TOL["transducer"] if transducer else VARIANT_BF16_TOL
    check(bool(torch.isfinite(got.float()).all()) and (err if transducer else rel) <= tol,
          f"[{phase}] {name} greedy: {'frames' if transducer else 'logits'} "
          f"{err if transducer else rel} > {tol} of the plain versions'")
    same = [bool(torch.equal(tokens[i, :c], p_tokens[i, :pc]))
            for i, (c, pc) in enumerate(zip(counts.tolist(), p_counts.tolist()))]
    return launches[0], wide[0], {"max_abs_diff": f"{err:.4g}", "rel_diff": f"{rel:.4g}",
                                  "plain_max_abs": f"{want_frames.float().abs().max().item():.4g}",
                                  "rows_tokens_equal": f"{sum(same)}/{len(same)}",
                                  "tokens": counts.tolist(), "tol": tol}


def phase_wide_bf16_slice(card_line):
    """[wide-bf16-slice]: WIDE_BF16_CONFIGS at published widths, heads and
    depth in the precision they ship (mixed_precision true: bf16): one
    training step through the Trainer (2 utterances of 16 and 8 s, dropout
    0, SpecAugment off, VN off) and one greedy batch, each against the same
    run through the plain versions on the card (check_step,
    counted_inference), every rel-pos launch on the tensor-core kernels
    that hold [qu | A] whole (none wide). Returns the rel-pos launches
    (forward, backward) summed over its runs."""
    from efficientconformer_torch.models import transducer as T
    from efficientconformer_torch.models.model_ctc import build_model

    total = [0, 0]
    for i, name in enumerate(WIDE_BF16_CONFIGS):
        path = f"configs/{name}.json"
        transducer = "Transducer" in name
        cfg = train_config(path, **({"vn_start_step": None} if transducer else {}))
        check(cfg["training_params"]["mixed_precision"], f"{name} ships in fp32")
        cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
        batch = train_batch(1, len(WIDE_FP32_SECONDS), [WIDE_FP32_SECONDS], [60, 30], "cpu",
                            np.random.default_rng(SEED + 130 + i))
        out = counted_step(cfg, batch, "wide-bf16-slice", name, torch.bfloat16)
        c32 = json.loads(json.dumps(cfg))
        c32["training_params"]["mixed_precision"] = False
        errs = check_step("wide-bf16-slice", name, torch.bfloat16, out,
                          one_step(c32, "cuda", batch, plain=True)[2])
        check(out["wide"] == (0, 0), f"[wide-bf16-slice] {name}: {out['wide']} wide launches")
        build = T.build_model if transducer else build_model
        model = perturb_norms_(build(path, "cuda", torch.bfloat16,
                                     torch.Generator().manual_seed(SEED)))
        fwd, wide, inf = counted_inference("wide-bf16-slice", name, model, cfg["encoder_params"],
                                           transducer)
        check(wide == 0, f"[wide-bf16-slice] {name} greedy: {wide} wide launches")
        total[0] += out["launches"][0] + fwd
        total[1] += out["launches"][1]
        say("wide-bf16-slice", config=name, dtype="bfloat16", seconds=list(WIDE_FP32_SECONDS),
            blocks=cfg["encoder_params"]["num_blocks"], loss=f"{out['loss']:.6f}",
            grad_norm=f"{out['grad_norm']:.6f}", **errs, step_launches=out["launches"],
            greedy_launches=fwd, route="tc", **{f"greedy_{k}": v for k, v in inf.items()},
            card=f"'{card_line}'")
        del model
        torch.cuda.empty_cache()
    return tuple(total)


def phase_wider_slice(card_line):
    """[wider-slice]: each of WIDER_MODELS (printed: what it changes and
    cuts) at full width: one training step in bf16 and one in fp32 through
    the Trainer (as [wide-bf16-slice]'s), and one bf16 greedy batch, each
    against the same run through the plain versions on the card, every
    rel-pos launch counted on the route it should take (wide where
    ``route`` names a wide one). Returns the rel-pos launches (forward,
    backward) and of them the wide ones, summed over its runs."""
    from efficientconformer_torch.config import load_config, resolve_block_configs

    total = np.zeros(4, dtype=np.int64)
    for i, name in enumerate(WIDER_MODELS):
        base, change, _ = WIDER_MODELS[name]
        cfg, enc = wider_encoder(name)
        enc.update(Pdrop=0.0, spec_augment=False)
        heads = sorted({(b.att_group_size * b.dim_model // b.num_heads, b.dim_model)
                        for b in resolve_block_configs(enc)})
        say("wider-model", name=name, base=base, change=json.dumps(change).replace(" ", ""),
            blocks=enc["num_blocks"],
            published_blocks=load_config(f"configs/{base}.json")["encoder_params"]["num_blocks"],
            heads_and_rel_widths=str(heads).replace(" ", ""))
        batch = train_batch(1, len(WIDE_FP32_SECONDS), [WIDE_FP32_SECONDS], [60, 30], "cpu",
                            np.random.default_rng(SEED + 140 + i))
        fp32_grads = None
        for dtype in (torch.float32, torch.bfloat16):   # fp32 first: the bf16 yardstick
            c = json.loads(json.dumps(cfg))
            c["training_params"]["mixed_precision"] = dtype == torch.bfloat16
            out = counted_step(c, batch, "wider-slice", name, dtype)
            errs = check_step("wider-slice", name, dtype, out, fp32_grads)
            fp32_grads = out["plain"][2]
            total += np.asarray([*out["launches"], *out["wide"]])
            say("wider-slice", model=name, step=str(dtype).removeprefix("torch."),
                loss=f"{out['loss']:.6f}", grad_norm=f"{out['grad_norm']:.6f}", **errs,
                launches=out["launches"], wide_launches=out["wide"], card=f"'{card_line}'")
            del out
            torch.cuda.empty_cache()
        model = ctc_model(enc, torch.bfloat16, cfg["tokenizer_params"]["vocab_size"])
        fwd, wide, inf = counted_inference("wider-slice", name, model, enc)
        total += np.asarray([fwd, 0, wide, 0])
        say("wider-slice", model=name, greedy="bfloat16", launches=fwd, wide_launches=wide,
            **inf)
        del model
        torch.cuda.empty_cache()
    return tuple(int(x) for x in total)


# ------------------------------------------------ the bias kernels past 256


def causal_wide_encoder() -> tuple[dict, dict]:
    """(config, encoder_params) of [causal-wide-slice]: WIDER_MODELS'
    EfficientConformer CTC Large at 4 heads at its published widths and
    depth, made causal with left context STREAM_LEFT as [stream-kernel]
    makes the flagship: every attention layer on the skewing path onto the
    bias kernels, stage 1's grouped head 3 x 360 / 4 = 270."""
    from efficientconformer_torch.config import load_config

    base, change, _ = WIDER_MODELS[CAUSAL_WIDE_MODEL]
    cfg = load_config(f"configs/{base}.json")
    cfg["encoder_params"].update(change, causal=True, left_context=STREAM_LEFT)
    return cfg, cfg["encoder_params"]


def widest_shapes(gen):
    """[widest-kernel]'s two timed shapes of the causal 4-head Large's stage
    1, by label: its serving window (SERVE_GEOMETRY, STREAM_SLOTS slots of
    ragged lengths) and its training step's (2 utterances of 8 s, one of
    them 6 s), each (B, H, N, the causal (B, H, N, N) bias on the card)."""
    from efficientconformer_torch import streaming as S

    p = causal_wide_encoder()[1]
    h = p["num_heads"]
    frames, g, dh = stream_stage_shapes(p, S.WindowGeometry(p, **SERVE_GEOMETRY).window_frames)[0]
    check(dh == 270, f"[widest-kernel] the causal 4-head Large's stage-1 head is {dh}")
    out = {}
    lengths = torch.linspace(1, frames, STREAM_SLOTS).round().long()
    bias, _ = stream_bias(STREAM_SLOTS, h, frames, g, STREAM_LEFT, 0, lengths, gen)
    out["window"] = (STREAM_SLOTS, h, bias.shape[-1], bias.cuda())
    _, n, dh, _, _, g = stage_shapes(p, 8.0)[0]
    frames = n * g
    lengths = torch.tensor([frames, frames * 3 // 4])
    bias, _ = stream_bias(2, h, frames, g, STREAM_LEFT, 0, lengths, gen)
    out["train"] = (2, h, bias.shape[-1], bias.cuda())
    return out


def check_widest_case(name, args, gen):
    """check_bias_case on ``args`` (both kernels, fp32 and bf16, at their
    gates), each call counted on the route ``route`` names and that route
    the compiled kernel files' own; then the backward without dS gives
    dq, dk and dv bit for bit as with it. The largest fp32 errors and the
    checked calls' launches by route, (forward, backward)."""
    from efficientconformer_torch.ops import bias_attention as BA

    q, k, v, bias, scale = args
    nq, nk, dqk, dv = q.shape[2], k.shape[2], q.shape[3], v.shape[3]
    err = check_bias_case(name, args, gen, phase="widest-kernel")
    routes = (dict(BA.bias_attention.routes), dict(BA.bias_attention_bwd.routes))
    for backward, counter in zip((False, True), routes):
        want = {}
        for dtype in (torch.float32, torch.bfloat16):
            r = BA.route(dtype, nq, nk, dqk, dv, backward)
            pad = (lambda x: -(-x // 8) * 8) if dtype == torch.bfloat16 else int
            check(BA.kernel_route(dtype, nq, nk, pad(dqk), pad(dv), backward)
                  == (r.name, tuple(b for _, b in r.kernels)),
                  f"[widest-kernel] {name}: the route table is not the kernel files' own")
            want[r.name] = want.get(r.name, 0) + 1
        check(dict(counter) == want and all(n.endswith("_chunked") for n in want),
              f"[widest-kernel] {name}: routes {dict(counter)}, expected {want}")
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) for t in (q, k, v)]
        o, lse = BA.bias_attention_fwd(*a, bias, scale)
        do = torch.randn(o.shape, generator=gen).to("cuda", dtype)
        with_ds = BA.bias_attention_bwd(*a, bias, o, do, lse, scale)
        no_ds = BA.bias_attention_bwd(*a, bias, o, do, lse, scale, need_dbias=False)
        check(no_ds[3] is None and all(torch.equal(x, y) for x, y in zip(with_ds[:3], no_ds[:3])),
              f"[widest-kernel] {name} {dtype}: the backward without dS differs")
    return err, routes


def phase_widest_kernel():
    """[widest-kernel]: both bias kernels past a width of 256, on their
    chunked routes, vs their plain versions (check_widest_case: fp32 1e-4,
    gradients 1e-4 relative; bf16 KERNEL_BF16_TOL, gradients GRAD_BF16_TOL)
    at WIDEST_WIDTHS: at the causal 4-head Large's stage-1 serving window
    (32 slots, H 4) with its causal window bias, a key mask, a
    head-broadcast bias and none; and one query row against
    WIDEST_STEP_KEYS keys (B 1, H 12: the LM's KV-cache step shape).
    [widest-kernel-time]: each width at the window and at the training
    step's stage-1 shape, forward and backward (with dS), bf16 and fp32,
    from CUDA graphs, beside the plain version, SDPA (the bias as its mask
    and, backward, given a gradient, on inputs zero-padded to a multiple of
    8 columns; fp32 through its math path) and the bound. Returns the
    largest fp32 errors (forward, backward) and the timed rows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from efficientconformer_torch.ops import bias_attention as BA

    gen = torch.Generator().manual_seed(SEED + 150)
    shapes = widest_shapes(gen)
    b, h, n, window = shapes["window"]
    err_f = err_b = 0.0
    cases = 0
    launches = ({}, {})

    def checked(name, args):
        nonlocal err_f, err_b, cases
        (ef, eb), routes = check_widest_case(name, args, gen)
        err_f, err_b, cases = max(err_f, ef), max(err_b, eb), cases + 1
        for total, counted in zip(launches, routes):
            for route, n_calls in counted.items():
                total[route] = total.get(route, 0) + n_calls

    for dqk, dv in WIDEST_WIDTHS:
        for layout in ("causal", "keymask", "head", "none"):
            args = bias_inputs(b, h, n, n, dqk, dv, "head" if layout == "head" else "keymask",
                               gen)
            bias = {"causal": window, "none": None}.get(layout, args[3])
            checked(f"{dqk}/{dv}-{layout}", (*args[:3], bias, args[4]))
        for nk in WIDEST_STEP_KEYS:
            heads = lm_params()["num_heads"]
            q, k, v = (torch.randn(1, heads, m, w, generator=gen).cuda()
                       for m, w in ((1, dqk), (nk, dqk), (nk, dv)))
            bias = torch.randn(1, heads, 1, nk, generator=gen).cuda()
            checked(f"{dqk}/{dv}-row-{nk}", (q, k, v, bias, 1.0 / math.sqrt(dqk)))
    say("widest-kernel", cases=cases, widths=" ".join(f"{a}/{c}" for a, c in WIDEST_WIDTHS),
        window=f"B{b}xH{h}xN{n}", row_keys=",".join(map(str, WIDEST_STEP_KEYS)),
        fp32_max_err=f"{err_f:.3g}", fp32_bwd_max_abs_err=f"{err_b:.3g}",
        launches_fwd=launches[0], launches_bwd=launches[1],
        tol=f"{KERNEL_FP32_TOL}/{GRAD_TOL}/{KERNEL_BF16_TOL}/{GRAD_BF16_TOL}")

    rows = {}
    for label, (b, h, n, bias) in shapes.items():
        for dqk, dv in WIDEST_WIDTHS:
            args = bias_inputs(b, h, n, n, dqk, dv, "keymask", gen)
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (t.to(dtype) for t in args[:3])
                scale = args[4]
                o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
                do = torch.randn(o.shape, generator=gen).to("cuda", dtype)
                mask = bias.to(dtype)
                lq, lk, lv = (pad8(t).detach().requires_grad_() for t in (q, k, v))
                lmask = mask.detach().clone().requires_grad_()
                ldo = pad8(do)
                fp32 = dtype == torch.float32

                def library_fwd():
                    with sdpa_kernel(SDPBackend.MATH) if fp32 else contextlib.nullcontext():
                        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                              scale=scale)

                def library_bwd():
                    with sdpa_kernel(SDPBackend.MATH) if fp32 else contextlib.nullcontext():
                        out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                                             scale=scale)
                    return torch.autograd.grad(out, (lq, lk, lv, lmask), ldo)

                calls = {"forward": {
                    "kernel": lambda: BA.bias_attention_fwd(q, k, v, bias, scale),
                    "plain": lambda: BA.reference_bias_attention(q, k, v, bias, scale),
                    "library": library_fwd}, "backward": {
                    "kernel": lambda: BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale),
                    "plain": lambda: BA.reference_bias_attention_bwd(q, k, v, bias, do, scale),
                    "library": library_bwd}}
                for direction, fns in calls.items():
                    backward = direction == "backward"
                    row = {name: graph_ms(fn, iters=5, replays=2) for name, fn in fns.items()}
                    itemsize = 2 if dtype == torch.bfloat16 else 4
                    row["bound"], row["bound_by"] = bound(
                        *bias_cost(b, h, n, n, dqk, dv, itemsize, backward),
                        BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
                    kind = str(dtype).removeprefix("torch.")
                    route = BA.route(dtype, n, n, dqk, dv, backward).name
                    say("widest-kernel-time", shape=label, direction=direction, B=b, H=h, N=n,
                        dqk=dqk, dv=dv, dtype=kind, route=route, bound_by=row["bound_by"],
                        library="sdpa " + ("math" if fp32 else "default") + ", bias as mask"
                        + (", mask grad" if backward else ""),
                        **{f"{key}_ms": f"{val:.4f}" for key, val in row.items()
                           if key != "bound_by"})
                    rows[(label, dqk, dv, kind, direction)] = row
    return err_f, err_b, rows


def spied_bias_routes():
    """A context in which every bias kernel launch is also counted by (head
    width, route, direction), read where the wrappers count it (``route``,
    which they call once a launch): {(dqk, route name, "fwd" | "bwd"):
    launches}."""
    from efficientconformer_torch.ops import bias_attention as BA

    seen = {}
    route = BA.route

    def spy(dtype, nq, nk, dqk, dv, backward=False):
        r = route(dtype, nq, nk, dqk, dv, backward)
        key = (dqk, r.name, "bwd" if backward else "fwd")
        seen[key] = seen.get(key, 0) + 1
        return r

    return seen, mock.patch.object(BA, "route", spy)


def causal_wide_step(cfg, batch, dtype, fp32_grads):
    """One training step of a fresh Trainer over ``cfg`` through the bias
    kernels, counted (a block a direction a microbatch, none on the rel-pos
    kernels; by width and route), its ms (a second step, warm) and peak
    memory, and the same step through the plain versions on the card, held
    at check_step's gates of its type."""
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, spy = spied_bias_routes()
    reset_launch_counts()
    with spy:
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    counts, rel = bias_launch_counts(), rel_counts()
    routes = (dict(BA.bias_attention.routes), dict(BA.bias_attention_bwd.routes))
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernel = (float(loss), float(grad_norm),
              {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()},
              {n: b.cpu().clone() for n, b in trainer.model.named_buffers() if "running" in n})
    t0 = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del trainer
    torch.cuda.empty_cache()
    plain = one_step(cfg, "cuda", batch, plain=True)
    out = {"loss_rel": abs(kernel[0] - plain[0]) / abs(plain[0]),
           "norm_rel": abs(kernel[1] - plain[1]) / abs(plain[1]),
           "grad_rel": rel_diff(kernel[2], plain[2]), "stats_rel": rel_diff(kernel[3], plain[3]),
           "kernel": kernel, "plain": plain}
    check(math.isfinite(kernel[0]), f"[causal-wide-slice] {dtype}: loss {kernel[0]}")
    errs = check_step("causal-wide-slice", CAUSAL_WIDE_MODEL, dtype, out, fp32_grads)
    return out, errs, counts, rel, routes, seen, ms, peak


def stream_ctc(model, p, audio, n, plain):
    """Two rows streamed through StreamingCTC at SERVE_GEOMETRY in uneven
    pushes, through the kernels or the plain versions: (tokens, the emitted
    logits (2, frames, V) on the host, windows, wall seconds)."""
    from efficientconformer_torch import streaming as S

    sess = S.StreamingEncoderSession(model, p, batch_size=2, device="cuda", **SERVE_GEOMETRY)
    rec = S.StreamingCTC(sess)
    ems = []
    push, finish = sess.push, sess.finish

    def recorded(fn):
        def call(*args):
            out = fn(*args)
            ems.extend(out)
            return out
        return call

    sess.push, sess.finish = recorded(push), recorded(finish)
    t0 = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        pos = 0
        for bite in itertools.cycle((0.7, 1.9, 0.4)):
            step = int(bite * SAMPLE_RATE)
            rec.push(audio[:, pos:pos + step])
            pos += step
            if pos >= n[0]:
                break
        rec.finish(np.array(n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rec.tokens, np.concatenate([em.valid for em in ems], axis=1), len(ems), wall


def phase_causal_wide_slice(card_line):
    """[causal-wide-slice]: EfficientConformer CTC Large at 4 heads made
    causal (causal_wide_encoder) at its published widths and depth. One
    fp32 and one bf16 training step (2 x 4 ragged utterances of 4-8 s, as
    [train-slice]; dropout 0, SpecAugment off) against the same step through
    the plain versions on the card at check_step's gates (fp32:
    TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STATS_TOL; bf16: VARIANT_BF16_TOL,
    BF16_GRAD_NOISE, BF16_LEAF_NOISE against the plain fp32 step); then the
    model streamed in bf16 and in fp32 through StreamingCTC at
    SERVE_GEOMETRY over two utterances of CAUSAL_WIDE_STREAM_SECONDS, its
    logits held to the same stream through the plain versions (fp32:
    STREAM_TOL and the tokens equal; bf16: VARIANT_BF16_TOL of the largest
    logit, the rows whose tokens are equal counted). Every bias launch
    counted by width and route: stage 1's head 270 on the chunked kernels in
    both directions and both types. Prints ms a step, ms a window step and
    peak memory. Returns the launches (forward, backward) and, of them, on
    the chunked routes."""
    from efficientconformer_torch.config import resolve_block_configs
    from efficientconformer_torch.ops import bias_attention as BA

    cfg, enc = causal_wide_encoder()
    enc.update(Pdrop=0.0, spec_augment=False)
    blocks = enc["num_blocks"]
    heads = [b.att_group_size * b.dim_model // b.num_heads for b in resolve_block_configs(enc)]
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED + 160))
    micro = batch["audio"].shape[0]
    say("causal-wide-model", name=CAUSAL_WIDE_MODEL, causal=True, left_context=STREAM_LEFT,
        blocks=blocks, heads=",".join(map(str, heads)))
    total = np.zeros(4, dtype=np.int64)
    fp32_grads = None
    for dtype in (torch.float32, torch.bfloat16):   # fp32 first: the bf16 yardstick
        c = json.loads(json.dumps(cfg))
        c["training_params"]["mixed_precision"] = dtype == torch.bfloat16
        out, errs, counts, rel, routes, seen, ms, peak = causal_wide_step(c, batch, dtype,
                                                                           fp32_grads)
        fp32_grads = out["plain"][2]
        want = {}
        for dh in heads:
            for bw in (False, True):
                key = (dh, BA.route(dtype, 1000, 1000, dh, dh, bw).name, "bwd" if bw else "fwd")
                want[key] = want.get(key, 0) + micro
        chunked = tuple(r.get("tc_chunked", 0) + r.get("fma_chunked", 0) for r in routes)
        check(counts == (blocks * micro, blocks * micro) and rel == (0, 0, 0, 0) and seen == want
              and chunked == (heads.count(270) * micro,) * 2,
              f"[causal-wide-slice] {dtype}: bias launches {counts}, rel-pos {rel}, by width "
              f"and route {seen}, expected {want}")
        total += np.asarray([*counts, *chunked])
        say("causal-wide-slice", step=str(dtype).removeprefix("torch."),
            loss=f"{out['kernel'][0]:.6f}", grad_norm=f"{out['kernel'][1]:.6f}", **errs,
            launches=list(counts), routes_fwd=routes[0], routes_bwd=routes[1],
            by_width=" ".join(f"{dh}:{r}:{d}={n}" for (dh, r, d), n in sorted(seen.items())),
            ms_per_step=f"{ms:.2f}", peak_mem_gib=f"{peak:.3f}", card=f"'{card_line}'")
        del out
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 161)
    n = [int(s * SAMPLE_RATE) for s in CAUSAL_WIDE_STREAM_SECONDS]
    audio = (rng.standard_normal((2, n[0])) * 0.1).astype(np.float32)
    audio[1, n[1]:] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        model = ctc_model(enc, dtype, cfg["tokenizer_params"]["vocab_size"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen, spy = spied_bias_routes()
        reset_launch_counts()
        with spy:
            tokens, logits, windows, wall = stream_ctc(model, enc, audio, n, plain=False)
        counts, rel = bias_launch_counts(), rel_counts()
        routes = dict(BA.bias_attention.routes)
        peak = torch.cuda.max_memory_allocated() / 2**30
        p_tokens, p_logits, p_windows, _ = stream_ctc(model, enc, audio, n, plain=True)
        chunked = routes.get("tc_chunked", 0) + routes.get("fma_chunked", 0)
        check(counts == (blocks * windows, 0) and rel[0] == 0
              and chunked == heads.count(270) * windows and p_windows == windows,
              f"[causal-wide-slice] stream {dtype}: bias launches {counts}, rel-pos {rel[0]}, "
              f"routes {routes} over {windows} windows")
        err = float(np.abs(logits - p_logits).max())
        scale = max(float(np.abs(p_logits).max()), 1.0)
        same = [a == b for a, b in zip(tokens, p_tokens)]
        if dtype == torch.float32:
            check(np.isfinite(logits).all() and err <= STREAM_TOL and all(same),
                  f"[causal-wide-slice] stream fp32: logits {err} > {STREAM_TOL} or tokens differ")
        else:
            check(np.isfinite(logits).all() and err / scale <= VARIANT_BF16_TOL,
                  f"[causal-wide-slice] stream bf16: logits {err / scale} > {VARIANT_BF16_TOL} "
                  "of the plain versions' largest")
        total += np.asarray([counts[0], 0, chunked, 0])
        say("causal-wide-slice", stream=str(dtype).removeprefix("torch."),
            seconds=list(CAUSAL_WIDE_STREAM_SECONDS), **SERVE_GEOMETRY, windows=windows,
            frames=logits.shape[1], max_abs_diff=f"{err:.4g}", rel_diff=f"{err / scale:.4g}",
            tol=STREAM_TOL if dtype == torch.float32 else VARIANT_BF16_TOL,
            rows_tokens_equal=f"{sum(same)}/{len(same)}", tokens=[len(t) for t in tokens],
            launches=counts[0], routes=routes,
            by_width=" ".join(f"{dh}:{r}={c}" for (dh, r, _), c in sorted(seen.items())),
            ms_per_window=f"{wall * 1e3 / windows:.2f}", peak_mem_gib=f"{peak:.3f}",
            card=f"'{card_line}'")
        del model
        torch.cuda.empty_cache()
    return tuple(int(x) for x in total)


def phase_profile():
    from efficientconformer_torch.models import transducer as T
    from efficientconformer_torch.models.model_ctc import greedy_decode

    n = int(TIME_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(SEED).standard_normal((TIME_BATCH, n)) * 0.1).astype(np.float32)
    x = torch.from_numpy(audio).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    model = make_model("cuda", torch.bfloat16)
    t_model = make_transducer("cuda", torch.bfloat16)
    cap = T.greedy_token_cap(t_encoder_params(), n, MAX_CONSEC)
    trainer, batch = rate_trainer()
    t_trainer, t_batch = t_rate_trainer()
    lm_scorer, lm_mb = lm_score_setup()
    lm_trainer, lm_train_batch = lm_rate_trainer()
    paths = {"infer": lambda: greedy_decode(model, x, x_len),
             "train": lambda: trainer.train_step(batch),
             "t-infer": lambda: T.greedy_decode(t_model, x[:T_RATE_BATCH], x_len[:T_RATE_BATCH],
                                                cap, MAX_CONSEC),
             "t-train": lambda: t_trainer.train_step(t_batch),
             "lm-score": lambda: lm_scorer.eval_loss(lm_mb),
             "lm-train": lambda: lm_trainer.train_step(lm_train_batch)}
    walls = {label: wall_ms(fn) for label, fn in paths.items()}
    for label, fn in paths.items():
        profile(label, fn, walls[label])
    # the beams, one batch each: CTC b32 x 10 s with the 6-gram; the
    # Transducer with LM-Transformer and the 6-gram at b4 x 2.5 s (a pop is
    # ~600 launches, so a 10 s batch would trace ~10^6 events)
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
    from efficientconformer_torch.decoding.ngram import ArpaLM
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models import lm as lm_mod

    dp = load_config(T_CONFIG)["decoding_params"]
    arpa256, arpa1000 = ArpaLM(synth_ngram(256)), ArpaLM(synth_ngram(1000))
    lm = lm_mod.build_model(LM_CONFIG, "cuda", torch.float32, torch.Generator().manual_seed(SEED))
    xb, xb_len = x[:CTC_BEAM_BATCH], x_len[:CTC_BEAM_BATCH]
    short = int(2.5 * SAMPLE_RATE)
    t_cap = T.greedy_token_cap(t_encoder_params(), short, MAX_CONSEC)

    @torch.inference_mode()
    def ctc_beam():
        logits, n = model(xb, xb_len)
        return ctc_beam_search_device(torch.log_softmax(logits.float(), -1), n, BEAM,
                                      ngram=arpa256, alpha=dp["ngram_alpha"],
                                      beta=dp["ngram_beta"])

    t_len = torch.full((T_BEAM_BATCH,), short, device="cuda")

    def t_beam():
        return beam_search_device(t_model, x[:T_BEAM_BATCH, :short], t_len, beam_size=BEAM,
                                  max_tokens=t_cap, lm_model=lm, lm_weight=dp["lm_weight"],
                                  ngram=arpa1000, ngram_alpha=dp["ngram_alpha"],
                                  ngram_beta=dp["ngram_beta"])

    profile("ctc-beam", ctc_beam, wall_ms(ctc_beam))
    profile("t-beam", t_beam, wall_ms(t_beam, iters=1), iters=1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of every path")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    card_line = card()
    print(card_line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import _kernels, rel_attention as RA
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rnnt_loss as RL

    t0 = time.perf_counter()
    kernels = (RA.KERNEL, RA.KERNEL_BWD, RL.KERNEL_FWD, RL.KERNEL_BWD, BA.KERNEL, BA.KERNEL_BWD)
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        reports = list(pool.map(_kernels.build, kernels))
    for name in kernels:
        _kernels.load(name)
    say("build", kernels=",".join(kernels), seconds=f"{time.perf_counter() - t0:.2f}",
        rnnt_kernels="rnnt_fwd_kernel,rnnt_fwd_strip_kernel<2|4|8>,rnnt_fwd_readback_kernel,"
                     "rnnt_bwd_kernel,rnnt_bwd_strip_kernel<2|4|8>,rnnt_bwd_readback_kernel,"
                     "rnnt_grad_kernel<int|int64>")
    refs = BeamReferences()   # the beams' CPU sides, beside the card's phases
    for line in "\n".join(reports).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    # the rel-pos kernels' shared memory is dynamic, so ptxas does not report it
    enc_params = load_config(CONFIG)["encoder_params"]
    t_cfg = load_config(T_CONFIG)
    # at the stage shapes of all twelve ASR configs (ROADMAP Queue 1 item 16),
    # on both routes
    for path in ASR_CONFIGS:
        for name, n, dh, d, h, g in stage_shapes(load_config(path)["encoder_params"],
                                                 TRAIN_SECONDS):
            row = {}
            for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "fma")):
                fwd_b, bwd_b = RA.smem_bytes(dtype, dh, d)
                row.update({f"{route}_fwd_bytes": fwd_b, f"{route}_bwd_bytes": bwd_b,
                            f"{route}_kernels": "/".join(RA.route(dtype, dh, d, b)
                                                         for b in (False, True))})
            say("build-smem", config=path.split("/")[-1].removesuffix(".json"), shape=name,
                dh=dh, rel_width=d, limit=RA.SMEM_LIMIT, **row)

    dh = lm_params()["dim_model"] // lm_params()["num_heads"]
    for dtype, route in ((torch.bfloat16, "tensor-core"), (torch.float32, "fma")):
        for n in (101, 130):   # the LM's N, and the two-pass backward's
            fwd_b, bwd_b = BA.smem_bytes(dtype, n, dh, dh)
            say("build-smem", config="LM-Transformer", kernels="bias_attention", route=route,
                N=n, dh=dh, fwd_bytes=fwd_b,
                bwd_bytes="/".join(map(str, bwd_b)) + (" (one pass)" if len(bwd_b) == 1 else ""))

    # the Transducer's U+1, RNNT_WIDE's, the most one thread a position takes,
    # [rnnt-long-kernel]'s and [t-long-eval]'s
    for u1 in (91, 150, 1024, *sorted({u for _, _, u in RNNT_LONG_SHAPES} | {T_LONG_LABELS + 1})):
        threads, strip, ring, smem = RL.launch_geometry(u1)
        say("build-smem", kernels="rnnt_fwd,rnnt_bwd", U1=u1, threads=threads, strip=strip,
            ring=ring, bytes=smem, limit=RL.SMEM_LIMIT)

    max_err, err16, times = phase_kernel(enc_params)
    max_err_bwd, err16_bwd, times_bwd = phase_kernel_bwd(enc_params)
    launches, fwd_tc = phase_requests()
    phase_slice()
    phase_rate(card_line)
    phase_train_slice()
    phase_train_learns()
    launches_bwd, tc_bwd, train_rate_ms = phase_train_rate(card_line)
    # [dp-slice]'s two ranks run its steps first in [tp-slice]'s launch
    t_tp = time.perf_counter()
    shared = dp_cases()
    tp_slice = phase_tp_slice(card_line, cut=True, extra=shared)
    say("tp-slice-time", seconds=f"{time.perf_counter() - t_tp:.2f}",
        note="the launch ran [dp-slice]'s steps too")
    dp_slice = phase_dp_slice(card_line, cases=shared, launched=tp_slice["extra"])
    dp_rate = phase_dp_rate(card_line, train_rate_ms)
    tp_fwd, tp_bwd, tp_bias_fwd, tp_bias_bwd = phase_tp_kernel()
    t_tp3 = time.perf_counter()
    tp3_slice = phase_tp3_slice(card_line)
    say("tp3", seconds=f"{time.perf_counter() - t_tp3:.2f}")
    check(all(tp3_slice), f"[tp3-slice] missed a rel-pos kernel: {tp3_slice}")
    phase_tp_cli()
    t_sp = time.perf_counter()
    sp_fwd, sp_bwd, sp_bias = phase_sp_kernel()
    skew_cases = sp_skew_cases()
    sp_slice, skew_outs, sp_ranks_s = phase_sp_slice(card_line, cut=True, extra=skew_cases)
    t_skew = time.perf_counter()
    sp_skew = phase_sp_skew_slice(card_line, skew_cases, skew_outs, sp_ranks_s)
    say("sp-skew", seconds=f"{time.perf_counter() - t_skew:.2f}",
        note="its ranks ran in [sp-slice]'s launch")
    phase_sp_cli()
    say("sp", seconds=f"{time.perf_counter() - t_sp:.2f}")
    check(all(sp_skew), f"[sp-skew-slice] missed a bias kernel: {sp_skew}")
    (t_err, t_err16), (t_err_bwd, t_err16_bwd) = phase_t_kernel(t_cfg["encoder_params"])
    err_rnnt, times_rnnt, err_rnnt_bwd, times_rnnt_bwd = phase_rnnt_kernel(t_cfg)
    t_long = time.perf_counter()
    ptxas = ptxas_rows(reports[kernels.index(RL.KERNEL_FWD)]
                       + reports[kernels.index(RL.KERNEL_BWD)])
    err_long, err_long_bwd, long_rows = phase_rnnt_long_kernel(ptxas)
    long_launches, err_long_eval, err_long_eval_bwd, long_eval_ms = phase_t_long_eval(card_line)
    say("rnnt-long", seconds=f"{time.perf_counter() - t_long:.2f}")
    t_launches, t_tc = phase_t_requests()
    phase_t_slice()
    phase_t_rate(card_line)
    phase_t_train_slice()
    phase_t_train_learns()
    rnnt_fwd, rnnt_bwd, t_fwd, t_bwd, t_fwd_tc, t_bwd_tc = phase_t_train_rate(card_line)
    check(t_launches > 0 and t_fwd > 0 and t_bwd > 0, "the Transducer paths missed a kernel")
    check(t_tc == t_launches and t_fwd_tc == t_fwd and t_bwd_tc == t_bwd,
          "a bf16 Transducer path missed the tensor-core route")
    err_bias, times_bias, err_bias_bwd, times_bias_bwd = phase_lm_kernel()
    phase_lm_slice()
    lm_score_launches = phase_lm_score_rate(card_line)
    phase_lm_train_slice()
    phase_lm_train_learns()
    lm_fwd, lm_bwd = phase_lm_train_rate(card_line)
    check(lm_score_launches > 0 and lm_fwd > 0 and lm_bwd > 0, "the LM paths missed a kernel")
    arpa256, arpa256_path = phase_ngram_device()
    ctc_beam_launches, _ = phase_ctc_beam(card_line, arpa256, arpa256_path)
    t_beam_launches, _, _ = phase_t_beam(card_line, refs)
    step_err, step_err16, times_step = phase_lm_step_kernel()
    phase_growing_cache()
    host_bias, host_rel, _ = phase_t_host_beam(card_line, refs)
    refs.stop()
    err_stream, times_stream = phase_stream_kernel()
    stream_launches, stream_rel, err_stream_exact = phase_stream_exact()
    serve_rel, serve_bias, (err_serve, err16_serve) = phase_serve_slice(card_line)
    rate_rel, rate_bias = phase_serve_rate(card_line)
    check(stream_launches > 0 and serve_rel > 0, "the streaming paths missed a kernel")
    cli = phase_cli(card_line, train_rate_ms, {256: arpa256_path, 1000: synth_ngram(1000)})
    cli_launches = {RA.KERNEL: cli[0], RA.KERNEL_BWD: cli[2], RL.KERNEL_FWD: cli[4],
                    RL.KERNEL_BWD: cli[5], BA.KERNEL: cli[6], BA.KERNEL_BWD: cli[8]}
    check(all(cli_launches.values()), f"the CLI's path missed a kernel: {cli_launches}")
    check(cli[1] == cli[0] and cli[3] == cli[2] and cli[7] == cli[6] and cli[9] == cli[8],
          f"a bf16 CLI path missed the tensor-core route: {cli}")
    interctc_fwd, interctc_bwd = phase_interctc_step(card_line, train_rate_ms)
    remat_fwd, remat_bwd = phase_remat(card_line)
    variant_fwd, variant_bwd = phase_variants(card_line)
    err_wide, err_wide_bwd, wide_rows = phase_wide_kernel()
    medium_launches, err_medium = phase_stream_medium()
    check(variant_fwd > 0 and variant_bwd > 0 and medium_launches > 0,
          "the variants' paths missed a bias kernel")
    t_wide = time.perf_counter()
    err_wide32, err_wide32_bwd, wide32_times = phase_wide_fp32_kernel()
    wide32_launches = phase_wide_fp32_slice(card_line)
    say("wide-fp32", seconds=f"{time.perf_counter() - t_wide:.2f}")
    check(all(wide32_launches), f"the wide fp32 steps missed a kernel: {wide32_launches}")
    t_wider = time.perf_counter()
    wider_errs, wider_times = phase_wider_kernel()
    wide16_launches = phase_wide_bf16_slice(card_line)
    wider_launches = phase_wider_slice(card_line)
    say("wider", seconds=f"{time.perf_counter() - t_wider:.2f}")
    check(all(wide16_launches) and all(wider_launches),
          f"the wide phases missed a kernel: {wide16_launches}, {wider_launches}")
    t_widest = time.perf_counter()
    err_widest, err_widest_bwd, widest_rows = phase_widest_kernel()
    causal_wide = phase_causal_wide_slice(card_line)
    say("widest", seconds=f"{time.perf_counter() - t_widest:.2f}")
    check(all(causal_wide), f"[causal-wide-slice] missed a chunked kernel: {causal_wide}")
    t_ctx = time.perf_counter()
    err_contextnet = phase_contextnet()
    say("contextnet-time", seconds=f"{time.perf_counter() - t_ctx:.2f}")

    def wide(direction):
        return {f"wide_{w}_{k}_ms": wide_rows[(w, direction)][k] for w in (135, 256)
                for k in ("kernel", "plain", "bound", "library")}

    def wide_route(name, i, direction, kernels):
        """The entry of a wide route: its launches in [wider-slice] (the main
        path that reaches it), [wider-kernel]'s largest errors (fp32, bf16
        relative for the backward) and [wider-kernel-time]'s sums over the
        wide rows (the library: SDPA on the augmented features, bf16
        memory-efficient or fp32 math)."""
        t = wider_times[direction]
        key = "bwd" if i else "fwd"
        return {"name": name, "route": "cuda", "source": source[i], "kernels": kernels,
                "replaces": replaces[i], "launches": wider_launches[2 + i],
                "max_abs_err": wider_errs[f"fp32_{key}"],
                "bf16_max_err": wider_errs[f"bf16_{key}"], "ms": t["kernel"],
                "plain_ms": t["plain"], "bound_ms": t["bound"], "bound_by": t["bound_by"],
                "library_ms": t["library"], "tc_wide_ms": t["tc_wide"],
                "fma_wide_ms": t["fma_wide"]}

    source = ("efficientconformer_torch/csrc/rel_attention_fwd.cu",
              "efficientconformer_torch/csrc/rel_attention_bwd.cu")
    replaces = ("efficientconformer_tpu/ops/pallas_rel_attention.py:122",
                "efficientconformer_tpu/ops/pallas_rel_attention.py:139")

    def wide32(direction, i):
        """[wide-fp32-kernel-time]'s sums (the library: SDPA's fp32 math
        path) and [wide-fp32-slice]'s launches of this direction."""
        t = wide32_times[direction]
        return {"wide_fp32_launches": wide32_launches[i],
                "wide_fp32_max_err": err_wide32_bwd if i else err_wide32,
                **{f"wide_fp32_{k}_ms": t[k] for k in ("kernel", "bf16", "plain", "library",
                                                       "bound")},
                "wide_fp32_bound_by": t["bound_by"]}
    def long_route(i):
        """The strip routes past 1,024 label positions: [t-long-eval]'s
        launches on them (an evaluation runs no backward), the largest
        errors of [rnnt-long-kernel] and [t-long-eval], and
        [rnnt-long-kernel]'s ms, plain ms and bound at each shape, and
        the read-back route's ms where the strip is held in registers."""
        key = ("fwd", "bwd")[i]
        errs = ((err_long, err_long_eval), (err_long_bwd, err_long_eval_bwd))[i]
        return {"long_eval_strip_launches": long_launches if i == 0 else 0,
                "long_max_abs_err": max(errs),
                "long_eval_kernel_ms": long_eval_ms["kernel"] if i == 0 else None,
                "long_ms": {"x".join(map(str, k)): {"ms": r[key], "plain_ms": r[f"plain_{key}"],
                                                   "bound_ms": r[f"{key}_bound"],
                                                   "bound_by": r[f"{key}_bound_by"],
                                                   "readback_ms": r.get(f"readback_{key}")}
                            for k, r in long_rows.items()}}

    def chunked_route(i, direction, kernels):
        """The entry of a bias kernel's chunked route (past a width of 256):
        its launches in [causal-wide-slice] (the main path that reaches it),
        [widest-kernel]'s largest fp32 error and [widest-kernel-time]'s sums
        over its rows (every width, both shapes and types; the library: SDPA
        with the bias as its mask, fp32 through its math path)."""
        rows = [r for key, r in widest_rows.items() if key[4] == direction]
        by = [r["bound_by"] for r in rows]
        return {"name": f"{(BA.KERNEL, BA.KERNEL_BWD)[i]}:chunked", "route": "cuda",
                "source": f"efficientconformer_torch/csrc/{(BA.KERNEL, BA.KERNEL_BWD)[i]}.cu",
                "kernels": kernels,
                "replaces": ("efficientconformer_tpu/ops/pallas_attention.py:55",
                             "efficientconformer_tpu/ops/pallas_attention.py:412")[i],
                "launches": causal_wide[2 + i], "max_abs_err": (err_widest, err_widest_bwd)[i],
                "ms": sum(r["kernel"] for r in rows), "plain_ms": sum(r["plain"] for r in rows),
                "bound_ms": sum(r["bound"] for r in rows), "bound_by": max(set(by), key=by.count),
                "library_ms": sum(r["library"] for r in rows), "rows": len(rows),
                "causal_wide_launches": causal_wide[i], "sp_skew_launches": sp_skew[2 + i]}

    if opts.profile:
        phase_profile()

    # bias_attention_fwd also replaces _flash_kernel (pallas_attention.py:272),
    # bias_attention_bwd also _bwd_dkv_kernel (:446)
    def entry(name, source, replaces, n, err, t, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"], "library_ms": t["library"],
                "cli_launches": cli_launches[name], **extra}

    # the rel-pos entries: ms and library_ms from CUDA graphs (device time),
    # eager_ms per eager call; max_abs_err fp32 (the FMA route), bf16_max_err
    # the tensor-core route's (the backward's relative to max(max|g|, 1))
    print(json.dumps({"kernels": [
        entry(RA.KERNEL, "efficientconformer_torch/csrc/rel_attention_fwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:122", launches,
              max(max_err, t_err, err_serve), times,
              bf16_max_err=max(err16, t_err16, err16_serve),
              tc_launches=fwd_tc, graph_ms=times["kernel"], eager_ms=times["kernel_call"],
              beam_launches={"ctc-beam": ctc_beam_launches, "t-beam": t_beam_launches,
                             "t-host-beam": host_rel},
              serve_launches={"stream-exact": stream_rel, "serve-slice": serve_rel,
                              "serve-rate": sum(rate_rel.values())},
              interctc_launches=interctc_fwd, remat_launches=remat_fwd,
              dp_launches={"dp-slice": dp_slice[0], "dp-rate": dp_rate[0]},
              tp_launches={"tp-slice": tp_slice["relpos"][0], "tp3-slice": tp3_slice[0]},
              tp_kernel_max_err=tp_fwd[0], tp_kernel_bf16_max_err=tp_fwd[1],
              tp_norm_rel_split=tp_slice["norm_rel_split"], contextnet_max_err=err_contextnet,
              sp_launches={"sp-slice": sp_slice[0]},
              sp_kernel_max_err=sp_fwd[0], sp_kernel_bf16_max_err=sp_fwd[1],
              wide_bf16_launches=wide16_launches[0], wider_launches=wider_launches[0],
              **wide32("forward", 0)),
        entry(RA.KERNEL_BWD, "efficientconformer_torch/csrc/rel_attention_bwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:139", launches_bwd,
              max(max_err_bwd, t_err_bwd), times_bwd,
              bf16_max_err=max(err16_bwd, t_err16_bwd), tc_launches=tc_bwd,
              graph_ms=times_bwd["kernel"], eager_ms=times_bwd["kernel_call"],
              interctc_launches=interctc_bwd, remat_launches=remat_bwd,
              dp_launches={"dp-slice": dp_slice[1], "dp-rate": dp_rate[1]},
              tp_launches={"tp-slice": tp_slice["relpos"][1], "tp3-slice": tp3_slice[1]},
              tp_kernel_max_err=tp_bwd[0], tp_kernel_bf16_max_err=tp_bwd[1],
              sp_launches={"sp-slice": sp_slice[1]},
              sp_kernel_max_err=sp_bwd[0], sp_kernel_bf16_max_err=sp_bwd[1],
              wide_bf16_launches=wide16_launches[1], wider_launches=wider_launches[1],
              **wide32("backward", 1)),
        wide_route("rel_attention_fwd:wide", 0, "forward",
                   ["rtc::prep_wide_kernel", "relpos_fwd_wide_tc_kernel<64|128>",
                    "rfma::prep_kernel<true>", "relpos_fwd_kernel<J> (column groups)"]),
        wide_route("rel_attention_bwd:wide", 1, "backward",
                   ["rtc::prep_wide_kernel", "relpos_bwd_k_wide_tc_kernel<64|128>",
                    "relpos_bwd_q_wide_tc_kernel<64|128>", "rfma::prep_kernel<true>",
                    "relpos_bwd_{k,da,dq,dw}_kernel"]),
        entry(RL.KERNEL_FWD, "efficientconformer_torch/csrc/rnnt_fwd.cu",
              "efficientconformer_tpu/ops/pallas_rnnt.py:73", rnnt_fwd, err_rnnt, times_rnnt,
              wide_fp32_launches=wide32_launches[2], **long_route(0)),
        entry(RL.KERNEL_BWD, "efficientconformer_torch/csrc/rnnt_bwd.cu",
              "efficientconformer_tpu/ops/pallas_rnnt.py:96", rnnt_bwd, err_rnnt_bwd,
              times_rnnt_bwd, wide_fp32_launches=wide32_launches[3], **long_route(1)),
        entry(BA.KERNEL, "efficientconformer_torch/csrc/bias_attention_fwd.cu",
              "efficientconformer_tpu/ops/pallas_attention.py:55", lm_fwd,
              max(err_bias, err_stream, err_stream_exact, step_err, err_wide, err_medium),
              times_bias, variants_launches=variant_fwd, stream_medium_launches=medium_launches,
              **wide("forward"),
              serve_launches={"stream-exact": stream_launches, "serve-slice": serve_bias,
                              "serve-rate": sum(rate_bias.values())},
              stream_kernel_ms=times_stream["kernel"], stream_plain_ms=times_stream["plain"],
              stream_bound_ms=times_stream["bound"], stream_library_ms=times_stream["library"],
              host_beam_launches=host_bias, step_bf16_max_err=step_err16,
              step_kernel_ms=times_step["kernel"], step_plain_ms=times_step["plain"],
              step_bound_ms=times_step["bound"], step_library_ms=times_step["library"],
              tp_launches={"tp-slice": tp_slice["bias"][0]}, tp_kernel_max_err=tp_bias_fwd,
              sp_launches={"sp-skew-slice": sp_skew[0]}, sp_kernel_max_err=sp_bias[0]),
        entry(BA.KERNEL_BWD, "efficientconformer_torch/csrc/bias_attention_bwd.cu",
              "efficientconformer_tpu/ops/pallas_attention.py:412", lm_bwd,
              max(err_bias_bwd, err_wide_bwd), times_bias_bwd, variants_launches=variant_bwd,
              **wide("backward"), tp_launches={"tp-slice": tp_slice["bias"][1]},
              tp_kernel_max_err=tp_bias_bwd, sp_launches={"sp-skew-slice": sp_skew[1]},
              sp_kernel_max_err=sp_bias[1]),
        chunked_route(0, "forward", ["bias_fwd_tc_chunked_kernel", "bias_fwd_chunked_kernel"]),
        chunked_route(1, "backward", ["bias_bwd_q_tc_chunked_kernel",
                                      "bias_bwd_k_tc_chunked_kernel",
                                      "bias_bwd_q_chunked_kernel", "bias_bwd_k_chunked_kernel"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
