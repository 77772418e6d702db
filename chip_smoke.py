#!/usr/bin/env python3
"""Smoke run of the PyTorch port (visualbert_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one result per line; any failure raises and the script exits
non-zero without printing the final line:

1. needs a CUDA device (there is no CPU path); prints the card's name and
   power limit as nvidia-smi reports them;
2. builds the CUDA kernels from visualbert_torch/csrc (nvcc, sm_90a, one
   process a source, all at once) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path: K3 (dropout mask, [128, 228, 768], int8 and
   bf16) must equal its bit-exact twin; the dropout site's forward and
   backward (K3's body, csrc/dropout.cu) at that shape, at NLVR2's
   [64, 272, 768], at the VCR step's [128, 148, 768], at the unsupervised
   step's [144, 102, 768], [144, 64, 768] and [144, 72, 768] and at the
   end-to-end step's [32, 102, 768], bf16, rate 0.1,
   must give y, the packed keep bits and dx
   bit for bit with their plain versions, keep a NaN planted at a dropped
   position NaN, and keep within 4 sigma of 0.9; the three are timed
   launched on preallocated tensors (the wrappers' host time beside) and
   printed with registers, local bytes (none may spill), blocks an SM, grid
   and TB/s, beside bernoulli_, F.dropout and
   aten.native_dropout_backward; K1 and K2 (packed attention forward and backward,
   B=128, T=228, H=12, D=64, bf16, padded keys) at dropout 0 and 0.1 must
   agree within a few bf16 ulps, timed at both rates, with each of their
   three kernels' head group, blocks an SM, registers and shared memory,
   and set beside their twin K16 at their own head groups (out, stats and
   dqkv bit for bit, times in the same call) and at K16's best hg; K1 and
   K2 again at the VCR step's shapes (128 rows = 32 questions x 4 choices,
   T = 128 text + 20 boxes, each row's text and some rows' boxes padded) at
   dropout 0 and 0.1 within the same limits, timed beside
   scaled_dot_product_attention and their bound; and at the unsupervised
   step's (144 rows, T = 30 text + 36 tags + 36 regions = 102, T = 64
   text-only and T = 36 + 36 = 72 image-only, each row's text padded after
   its length) and at the end-to-end step's (32 rows, T = 102) likewise,
   and on a phase-25 mesh rank's share of the main path's inputs: (2, 1)'s
   64 rows of 12 heads and (1, 2)'s 128 rows of 6 heads;
   K4, K5 and K6 (the fused MLM cross-entropy: forward, dx, d embedding and
   d bias) at N = 128 x 24 = 3072 rows, H=768, V=30522, bf16, 15 % of labels
   -1 and a non-uniform cotangent, again at bert-large's H=1024 and at
   vqa_advanced's N = 64 x 4 = 256 rows and at the unsupervised step's
   N = 144 x 30 = 4320 (V&L) and 144 x 64 = 9216 (text-only) rows and the
   end-to-end step's 32 x 30 = 960, with each step's own labels, most of
   them -1, and at a phase-25 mesh rank's N = 64 x 24 = 1536 (timed beside their bounds and
   cuBLAS's products there, with their grids and splits; the site kernels
   at the unsupervised shapes likewise beside F.dropout); K4
   (x in wgmma A fragments, a cp.async ring) and K5 and K6 (one wgmma
   kernel on two roles) printed at both widths with their registers, local
   bytes, shared bytes, blocks an SM, grid and splits (none may spill) and
   the TFLOP/s of their products, beside their first design's times and
   the same products through torch.matmul (K4's also at the vocabulary
   padded to a 16-byte row), K4 with its wrapper's host time a call; K3's
   bound (and the site forward's, beside its bytes) times its Philox calls
   at the rate csrc/bench/philox_rate.cu measures on K3's counter form,
   beside the instruction counts;
   K7-K10 (residual add + LayerNorm, without and with dropout,
   forward and backward) at the main path's N = 128 x 228 = 29,184 rows,
   H=768, bf16, K9/K10 at rate 0.1, with K9's saved keep bits and K10's
   dropped positions equal to the plain version's, K10 timed on K9's bits;
   K9/K10 printed with registers, local bytes (neither may spill), shared
   bytes, blocks an SM, ring stages and achieved TB/s, beside their first
   design's times and a device-to-device copy of K10's bytes; all within
   the limits below. Kernel, plain and
   library times come from CUDA events; each kernel's bound is computed
   from these shapes; K11/K12 (heads-major attention) and K13/K14 (with
   saved probabilities) at K1's shapes, dropout 0 and 0.1, each of K13's
   bf16 probabilities within one bf16 ulp of its plain value, and K14 fed
   K13's own probabilities and output against the plain chain; K13's
   probabilities must have the padded row stride K14 reads without a copy;
   K11/K12 and K13/K14 (on K1/K2's design) are printed with their head
   groups, blocks an SM, registers and shared memory (K11/K12 must not
   spill), timed at dropout 0 too, beside their first design's times
   (K14's two passes timed apart); K11/K12 must equal K1/K2 bit for bit on
   the same numbers with a zero QKV bias; K13/K14 run against K1 + K2 at
   NLVR2's shape (B=64, T=272); K15 (each of
   the 13 attention experiment variants of scripts/attn_exp.py) and K16
   (scripts/attn_hgrid.py at hg 6, 4, 2), K1/K2's design in kernels of
   their own, at K1's shapes and dropout 0 and 0.1, by K1/K2's measures,
   every variant timed beside the first design's "base" / hg=6 times, their
   12 kernels printed with registers, local bytes (none may spill), shared
   memory and blocks an SM. Then the path of K15/K16:
   both sweep tools (visualbert_torch.tools.attn_exp and ... attn_hgrid,
   their default sweeps at B=96) run as a user runs them, with every launch
   count set to 0 first; each variant must launch its kernels as the tools
   call them, and nothing but K1/K2 (their yardstick) may launch besides.
   Then the path of K3's mask, which no training path launches since the
   site kernels took its place: visualbert_torch.tools.dropout_steps run as
   a user runs it (its builds with a design step left out must give the
   kernels' bits), with every count set to 0 first: it must launch K3 and
   the site kernels through their wrappers and nothing else.
   Then K1/K2's and K4-K6's other forms: K1/K2 (ATTENTION_FORMS) in fp16
   and fp32 at the main path's [128, 228, 12 x 64], and in bf16, fp16 and
   fp32 at head dim 16 (bf16 and fp16: K1 zero-padded to 64, K2 on its
   unpadded D16 form), in bf16 and fp16 at 32 (K2 on its D32 form) and at
   128 (K2 on its streamed two-warpgroup passes, which must not spill,
   also at STREAMED_LONG_T, past the limit the passes had while they held a
   head's rows), at dropout 0 and 0.1, fp32 within F32_REL_TOL / F32_ABS_TOL of its
   plain version and the rest within the bf16 limits, two calls giving
   the same bits, each timed beside its plain version,
   scaled_dot_product_attention in its dtype and its bound (the
   redesigned forms also beside EARLIER_DESIGN_MS), with each kernel's
   registers, local bytes, shared bytes, blocks an SM, heads a block and
   T limit and the padding's own time (the fp32 kernels and K2's forms at
   16 and 32 may not spill); K4-K6 (XENT_FORMS) in bf16 at widths
   128, 256, 512 and 1024 (bert-large's; K5/K6 there on the 1024 form's
   clusters of two blocks, also in fp16, called twice, printed with their
   cluster and beside EARLIER_DESIGN_MS), in fp16 and fp32 at 768, in bf16
   and fp16 at 384 (zero-padded to 512, the copy of E timed alone), on the
   wide form in bf16 and fp16 at 2048 and 2560 (Megatron-BERT 1.3B's and
   3.9B's widths; K4 on 128 x 128 tiles fed by a producer warp's TMA,
   K5/K6 in thread-block clusters, printed with their cluster and TFLOP/s;
   db held to the exact products') and fp32 (the tiled kernels) at 1088 and
   2048, at the main path's N = 3072 and V = 30522, likewise (none may
   spill; fp32, wide and 1024 K4-K6 called twice must agree bit for bit),
   beside cuBLAS's products in the same dtype. Then K11/K12 and K13/K14 in the same forms
   (ATTENTION_FORMS) at the main path's [128, 228, 12 heads], dropout 0 and
   0.1, held as K1/K2's forms and K11-K14 are (K13's bf16 probabilities
   within one bf16 ulp in every dtype, K14 fed K13's own output), each
   timed beside its plain version, scaled_dot_product_attention in its
   dtype and its bound, with each kernel's registers, local bytes, shared
   bytes and blocks an SM (bf16 and fp16 with each kernel's head dim, heads
   a block and T limit; K12, K13 and K14 at D = 16 and 32 run on their
   small-row forms, which must not spill, and print beside SDPA and their
   padded route's earlier reading; the register-tiled fp32 kernels, every forward
   and backward, must not spill; check_f32_masks:
   each fp32 pair's dropout masks at T = 64 must be the bf16 kernels'
   at the same seed); and K7-K10 (LN_FORMS) at the main path's 29,184
   rows in bf16 at widths 64, 100, 1030 and 2048, fp16 at 2048 and fp32 at
   100 and 4096 (the warp and block forms, 16-byte and element loads),
   held as K7-K10 are (K9's bits [N, ceil(H / 8)] bit for bit), each timed
   beside its plain version, F.layer_norm in its dtype (K7/K8) and its
   bound, with registers, local bytes, shared bytes and blocks an SM; the
   two print their time;
4. a 2-layer model with dropout off gives the same loss through the kernels
   (K1/K2 attention, K4-K6 cross-entropy), through the kernels with the
   fused LayerNorm (K7/K8), through the heads-major attention (K11/K12,
   `"packed_qkv": false`), through the saved probabilities (K13/K14,
   `"flash_save_probs": true`) and through the einsum attention and the
   unfused decoder; then the same at bert-base width in fp32 (within
   SLICE_F32_REL_TOL) and fp16 and at BERT-Small's (L = 4, H = 512, A = 8)
   in bf16 (K11-K14's paths in bf16 at head dim 64 only);
5. drives the main path as configs/coco_pretrain.json ships it: the
   COCO-caption pretraining train step at bert-base width and depth with
   the config's `model` block unchanged, random seeded weights, a synthetic
   batch of the config's 128 pairs x (128 text + 100 regions), dropout on,
   bf16 compute, fp32 parameters and BertAdam state with the pooler frozen,
   schedule "none", lr 1e-4, STEPS steps on one repeated batch. Losses must
   be finite and fall, and every step must launch exactly 12 K1, 12 K2, 25
   dropout site forwards and 25 backwards (the embeddings' site and two a
   layer), one each of K4, K5 and K6, and no K3 mask and no K7-K16; its
   peak memory is printed beside the 14.43 GiB it took when each site saved
   a bf16 multiplier;
6. the same with `"use_fused_layer_norm": true` added to the block: every
   step launches 12 K1, 12 K2, one site forward and backward (the
   embeddings' dropout), one each of K4-K6, 24 K9 and 24 K10 and no K7/K8; that block with `"packed_qkv":
   false` (12 K11 and 12 K12 instead of K1/K2) and with `"flash_save_probs":
   true` (12 K13 and 12 K14 instead); then one step of the fused block with
   both dropout rates 0 (the setting of __graft_entry__.py's dry run): 24
   K7, 24 K8, no K3 site, K9 or K10;
7. runs the training CLI (`visualbert_torch.train_cli`) on
   configs/coco_pretrain.json with its data block swapped for a synthetic
   COCO set of CLI_EXAMPLES pairs and one epoch: 4 steps at the config's
   batch of 128, through the dataset, the Batcher, the fit loop and a
   checkpoint at the end of the epoch. Its losses must be finite, every step
   must launch each kernel as in phase 5, and the checkpoint must load back
   into a fresh model bit for bit;
8. runs VQA fine-tuning through the CLI: configs/vqa_finetune.json with its
   data block swapped for VQA_EXAMPLES synthetic questions (80 % train, 20 %
   eval) and `"use_fused_layer_norm": true` added to its model block, one
   epoch at its batch of 64: 5 train steps, each 12 K1, 12 K2, one site
   forward and backward, 24 K9, 24 K10; 2 eval batches after the epoch and 2 more for the prediction
   dump, each 12 K1 and 24 K7. Then `--eval_only --restore` of its
   checkpoint must give the epoch's val_ metrics within 1e-6 and the same
   vqa_predictions.json, one entry per eval question, launching only 2 x
   (12 K1, 24 K7);
9. runs NLVR2 fine-tuning through the CLI: configs/nlvr2_finetune.json
   with its data block swapped for NLVR2_EXAMPLES synthetic image pairs
   (80 % train, 20 % eval; T = 128 + 2 x 72 = 272) and `"flash_save_probs":
   true` added to its model block, one epoch at its batch of 64: 5 train
   steps, each 12 K13, 12 K14, 25 site forwards and 25 backwards; 3 eval batches of 32 after the epoch
   and 3 more for the report, each 12 K13. nlvr2_report.csv must hold one
   row per eval identifier, and `--eval_only --restore` must give the
   epoch's val_ loss and accuracy within 1e-6 and the same report, launching
   only 3 x 12 K13; its official accuracy must equal val_accuracy within
   1e-6. The synthetic identifiers are plain indices, each pair a sentence
   group of its own, so consistency equals the official accuracy here and
   checks nothing more;
10. runs VQA answer-as-MLM through the CLI: configs/vqa_finetune.json with
   `"task": "vqa_advanced"`, `"fused_mlm_xent": true` and
   `"use_fused_layer_norm": true` added, VQA_EXAMPLES synthetic questions,
   one epoch at batch 64: 5 train steps of the fused main path's launches
   (K4/K5/K6 1/1/1 a step, on 256 rows); 2 + 2 eval batches of 12 K1 and
   24 K7 and no K4-K6 (evaluation decodes the logits). `--eval_only
   --restore` must give the epoch's val_ metrics within 1e-6 and the same
   vqa_advanced_predictions.json, one entry per eval question;
11. runs Flickr30k grounding through the CLI: configs/flickr_finetune.json
   with its data block swapped for FLICKR_EXAMPLES synthetic captions (128
   text tokens + 100 regions, 16 entity slots), one epoch at its batch of
   32: 5 steps of 12 K1, 12 K2, 25 site forwards and 25 backwards; 2 + 2
   eval batches of 12 K1. Its losses must be finite; `--eval_only
   --restore` must give the epoch's val_ metrics within 1e-6 and R@1/5/10
   in [0, 1], not falling in k;
12. runs the attention probe through the CLI: configs/flickr_probe.json
   with that data block, --restore of phase 11's checkpoint, eval batches
   of 16 (the last one padded). flickr_probe.json must hold one entry per
   layer (12), the probe must launch no kernel (the einsum attention), and
   its per-layer hits must equal a recount from one [L, B, H, T, T]
   collection of the whole split; its peak memory is printed. The runs'
   folders are temporary directories, removed at the end;
13. drives the VCR train step at configs/vcr_finetune_qa.json's full size
   (visualbert_torch/tools/vcr_path.py): the ResNet50 detector (7 x 7 stem,
   FrozenBN, RoIAlign, layer4 over 20 boxes an image) and bert-base with the
   multichoice head, the config's model block unchanged, its optimizer
   block with schedule "none", seeded weights, 32 uint8 768 x 768 images
   whose content extent lies below 768 (so the padding is re-zeroed on the
   card), 4 choices x 128 tokens, STEPS steps on one repeated batch. The
   losses and cnn_regularization_loss must be finite, the loss must fall,
   and every step must launch exactly 12 K1, 12 K2, 25 site forwards and 25
   backwards and nothing else of K1-K16; the median step, images/s, peak
   memory and the detector's forward alone are printed;
14. runs VCR through the CLI: configs/vcr_finetune_qa.json with its data
   block swapped for VCR_EXAMPLES synthetic questions (32 x 32 images, 3
   boxes padded to 20), one epoch at its batch of 32: 5 steps of 12 K1, 12
   K2, 25 site forwards and backwards; 2 + 2 eval batches (the second
   padded) of 12 K1. `--eval_only --restore` must give the epoch's val_
   metrics within 1e-6 and the same vcr_logits.npy (one row per eval
   question) within 1e-5 with equal argmax;
15. runs vcr_coco_pretrain through the CLI: configs/coco_pretrain.json's
   model, optimizer and train blocks with `"task": "vcr_coco_pretrain"` and
   VCR_COCO_EXAMPLES synthetic captioned images, one epoch at batch 128: 4
   steps of the main path's launches (12/12 K1/K2, 1/1/1 K4-K6, 25 sites),
   4 eval batches of 12 K1 and one K4; its metrics must be finite;
16. drives the unsupervised pretraining step at configs/unsup_pretrain.json's
   full width (visualbert_torch/tools/unsup_path.py): UnsupervisedVisualBert
   with the config's model block unchanged, 1600 objects and 400
   attributes, its optimizer block with schedule "none", seeded weights,
   UNSUP_STEPS steps taking in turn a V&L batch (144 rows of 30 text
   tokens, 36 tags, 36 regions of 2048-d features), a text-only batch
   (144 x 64) and an image-only batch (the V&L batch's tags and regions,
   T = 72), the hybrid mix's three sources. Each source's losses must be
   finite and fall, and every V&L and text-only step must launch exactly
   12 K1, 12 K2, one each of K4-K6, 24 site forwards and 24 backwards (the
   embeddings' dropout is no site), every image-only step the same without
   K4-K6, and nothing else of K1-K16; each source's median step, rows/s and
   the peak memory are printed;
17. runs unsup_pretrain through the CLI: configs/unsup_pretrain.json with
   its data block swapped for UNSUP_EXAMPLES synthetic images (36 regions,
   2048-d), a PackedCorpus of UNSUP_PASSAGES passages that the phase builds
   and saves as the text_corpus, and UNSUP_VAL val images, one epoch at its
   batch of 144: 2 V&L and 2 text-only steps of phase 16's launches, one
   eval batch of 12 K1 and one K4; its metrics must be finite;
18. runs text_pretrain through the CLI: configs/coco_pretrain.json's model,
   optimizer and train blocks with "task": "text_pretrain" and
   TEXT_PRETRAIN_EXAMPLES synthetic passages of 64 tokens, one epoch at
   batch 128: 3 steps of the main path's launches (the fused cross-entropy
   over every text row); its losses must be finite;
19. runs unsup_vqa through the CLI: configs/unsup_pretrain.json's model
   block, UNSUP_VQA_EXAMPLES synthetic questions (20 tokens, 36 tags, 36
   regions), one epoch at batch 144: 2 steps of 12 K1, 12 K2 and 24 sites;
   one eval batch of 12 K1. `--eval_only --restore` must give the epoch's
   val_ metrics within 1e-6, launching only that eval batch's kernels;
20. drives the end-to-end unsupervised step (tools/unsup_e2e_path.py,
   BASELINE.json config 5): UnsupervisedEndToEnd with the full ResNet50
   detector (7 x 7 stem, layers (3, 4, 6), layer4 of 3 blocks) in the
   training graph feeding configs/unsup_pretrain.json's model block
   unchanged, E2E_ROWS uint8 768 x 768 images (the config's 144 rows cut to
   32: the detector over 144 such images does not fit one card) of 36
   boxes, 30 text tokens, features and tags masked jointly at 15 %, STEPS
   train steps through Trainer.train_step on one repeated batch. The
   losses must be finite, masked_lm_loss, matched_loss, obj_loss,
   feat_loss and masked_tag_loss must all be there, all but feat_loss must
   fall (feat_loss regresses the detector's own features, whose scale the
   updates move: the step prints that scale after each update beside it),
   the detector's first convolution must get a non-zero gradient every step,
   and every step must launch exactly 12 K1, 12 K2, one each of K4-K6 and
   24 site forwards and backwards (the encoder's; the embeddings' and the
   detector's dropout are stock) and nothing else of K1-K16; the median
   step, images/s and peak memory are printed;
21. restores a reference torch checkpoint through the CLI: a VQA run of
   TH_EXAMPLES synthetic questions (configs/vqa_finetune.json with the
   fused LayerNorm, one epoch) whose parameters are saved in the reference
   layout (`module.` prefix, LayerNorm gamma/beta) as a .th file; `--eval_only
   --restore` of that file must load every parameter equal to its source
   and give the epoch's val_ metrics within 1e-6;
22. builds the native WordPiece tokenizer (visualbert_torch/csrc/
   wordpiece.cpp, g++ into visualbert_torch/_build/) and holds it against
   the Python tokenizer on TOKENIZER_TEXTS, non-ASCII ones included, one
   string at a time and batched (equal ids), and times both on the host;
23. compares the Batcher's process workers with its thread workers on
   phase 7's COCO synthetic set (two epochs of batches of 128, 4 workers):
   every batch bit for bit. HDF5 features are not driven here: the card's
   machine has no h5py;
25. the (data, model) mesh (visualbert_torch/parallel) on the one card. (a)
   Two ranks over gloo (visualbert_torch/tools/mesh_path.py, each a process
   of its own; NCCL refuses two ranks on one device) run the main path at
   full width with the fused LayerNorm and both dropout rates 0,
   MESH_STEPS steps on the config's 128 pairs: on mesh (2, 1) (64 rows a
   rank) and on (1, 2) (6 heads and 1536 FFN columns a rank, the
   cross-entropy's rows split). Each must give the one-process run's
   losses within MESH_LOSS_TOL and every parameter's update within
   MESH_UPDATE_TOL (below), and every rank must launch 12 K1, 12 K2, one
   each of K4-K6, 24 K7 and 24 K8 a step. Then MESH_DROPOUT_STEPS steps on
   (1, 2) with dropout 0.1 (the embeddings' K3 site, K9/K10): every
   parameter that both ranks hold whole must stay bit-equal, and, before
   the trainer's broadcast of those gradients from model rank 0, model
   rank 1's whole-held gradients must be within MESH_GRAD_GAP_TOL of rank
   0's every step (peers that drew different hidden-state masks would be
   apart by the gradients' size). Each rank prints its launches a step,
   K1/K2's time on its heads, its median step, peak memory and its
   collectives' calls, time and bytes a step (the ranks share the card: no
   scaling is measured). (b)
   `torchrun --standalone --nproc_per_node 1 -m visualbert_torch.train_cli`
   (NCCL) on phase 7's COCO synthetic config with `"mesh_shape": [1, 1]`:
   one epoch of 4 steps whose checkpoint must load back;
27. (run before 26's table) trains GEOMETRY_EXAMPLES / 128 = 3 steps of
   coco_pretrain through the CLI on synthetic data with
   configs/coco_pretrain.json's blocks and flags in thirteen model
   geometries: the JAX package's tiny() (fp32, head dim 16, width 64, with
   the fused LayerNorm: all four kernel flags), bert-base in fp16,
   BERT-Small (Turc et al. 2019: L = 4, H = 512, A = 8, I = 2048) in bf16,
   bert-base in fp16 with `"packed_qkv": false` and the fused LayerNorm
   (K11/K12 in fp16), tiny() with `"flash_save_probs": true` (K13/K14 in
   fp32) and Megatron-BERT 1.3B's widths (Shoeybi et al. 2019, Table 4: H
   = 2048, A = 32, I = 8192; L cut from 24 to 2) in bf16 with the fused
   LayerNorm, fast_dropout (K9/K10 a block a row) and the fused
   cross-entropy (K4-K6 on the wide form, which the run must show), then
   bert-base in fp32 with the config's blocks and flags as shipped (K1 and
   the register-tiled fp32 K2, 12 a step; K4-K6 in fp32) and again with
   `"flash_save_probs": true` (the tiled fp32 K13 and K14), and the
   Megatron widths again in fp16 (Megatron-BERT's own mixed precision; K4-K6
   on the fp16 wide form, which the run must show), and TinyBERT-4 (Jiao et
   al. 2020: L = 4, H = 312, A = 12, I = 1200) in bf16 (heads of 26: K1
   padded to 64, K2 on its "bf16 D32" form), again with `"packed_qkv":
   false` (K11 padded, K12 on "bf16 D32") and with `"flash_save_probs":
   true` (K13 and K14 on "bf16 D32"), and bert-large's widths
   (VisualBertConfig.large: H = 1024, A = 16, I = 4096; L cut from 24 to
   2) in bf16 with the fused LayerNorm, fast_dropout and the fused
   cross-entropy (K5/K6 on the 1024 form, "bf16 H1024"); each run
   must be on the card, its losses finite, its launches those of its depth
   and flags (the attention pair L a step, K4-K6 one, the dropout sites or
   K9/K10), every launch of K1/K2, K4-K14 in the kernel form of its dtype
   and widths; each prints its median step time and peak memory, and the
   phase its time and the bert-base fp32 step beside BERT_BASE_F32_STEP_MS;
26. prints the kernel table as one JSON line (launches from phase 6: the
   fused-LayerNorm main path's STEPS steps, for K7/K8 its dropout-0 step,
   for K11-K14 the runs with their settings, for K15/K16 the tools' run,
   for K3's mask the calls of its wrapper in tools/dropout_steps.py's run
   (the tool's checks and timing rounds launch K3 directly and are not
   counted), for the site kernels the as-shipped steps; K15/K16's rows add every variant's time; K3 is three
   rows: mask, site forward, site backward; the fp32 kernels of K1/K2 and
   K4-K6 (csrc/flash_attention_f32.cu, csrc/mlm_xent_f32.cu) are five rows
   more, timed at the main path's shapes in fp32, their launches from
   phase 27's bert-base fp32 run; the forms of K11/K12 (fp16), K13/K14 (fp32,
   launches from the bert-base fp32 save-probs run),
   K9/K10 (bf16, a block a row), K4-K6 (bf16 and fp16, the wide form at
   2048; K5/K6 in bf16 at 1024, launches from the bert-large run) and
   K2, K12, K13 and K14 (bf16 D32) that phase 27 drives are eighteen rows
   more
   (FORM_KERNELS), timed at
   phase 3's shapes, their launches from their geometry's run), then {"ok":
   true, "device": {...}} as the last line.
"""

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

STEPS = 10
CLI_EXAMPLES = 512
VQA_EXAMPLES = 400
NLVR2_EXAMPLES = 400
REPO = os.path.dirname(os.path.abspath(__file__))
VQA_CONFIG = os.path.join(REPO, "configs", "vqa_finetune.json")
NLVR2_CONFIG = os.path.join(REPO, "configs", "nlvr2_finetune.json")
FLICKR_CONFIG = os.path.join(REPO, "configs", "flickr_finetune.json")
PROBE_CONFIG = os.path.join(REPO, "configs", "flickr_probe.json")
FLICKR_EXAMPLES = 200
FLICKR_DATA = {"synthetic": FLICKR_EXAMPLES, "max_seq_length": 128, "max_regions": 100, "max_entities": 16}
VQA_ADVANCED_XENT_ROWS = 64 * 4  # vqa_advanced's batch x its max_answer_tokens slots
VCR_EXAMPLES = 200  # 160 train (5 steps of 32), 40 eval (32 + a padded batch of 8)
VCR_COCO_EXAMPLES = 640  # 512 train (4 steps of 128), 128 eval (one batch)
VCR_ROWS, VCR_T = 32 * 4, 128 + 20  # K1/K2 on the VCR step: 32 questions x 4 choices, 128 tokens + 20 boxes
# the unsupervised step: the config's 144 rows; V&L 30 text + 36 tags + 36
# regions, text-only 64 tokens
UNSUP_ROWS, UNSUP_TT, UNSUP_N, UNSUP_TEXT_T = 144, 30, 36, 64
UNSUP_VL_T = UNSUP_TT + 2 * UNSUP_N
UNSUP_IMAGE_T = 2 * UNSUP_N   # the image-only source: 36 tags + 36 regions
UNSUP_STEPS = 12              # phase 16: four steps of each source in turn
E2E_ROWS = 32                 # the end-to-end step's batch, cut from the config's 144 (tools/unsup_e2e_path.py)
TH_EXAMPLES = 160             # the .th restore's VQA run: 128 train (2 steps of 64), 32 eval (one padded batch)
# the native tokenizer's check: ASCII and non-ASCII strings over a small vocabulary
TOKENIZER_VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jump ##s ##ed over a lazy dog ! , . un "
                   "##want run ##ning 1 2 3 ##0 hello world cafe ' s naive").split()
TOKENIZER_TEXTS = ["The quick brown fox jumps over the lazy dog!", "unwanted running",
                   "  weird   whitespace\tand\nnewlines ", "UNWANTED, RUNNING.", "120 30", "dog's",
                   "zzz unknownword", "", "!!!", "a" * 150, "café naïve", "中国 hello", "Ünwanted résumé, running!"]
UNSUP_EXAMPLES = 288          # 2 V&L steps of 144
UNSUP_PASSAGES = 288          # 2 text-only steps
UNSUP_VAL = 144               # one eval batch
TEXT_PRETRAIN_EXAMPLES = 384  # 3 steps of 128
UNSUP_VQA_EXAMPLES = 360      # 288 train (2 steps of 144), 72 eval (one padded batch of 144)
# Tolerances. The kernels round unnormalised probabilities to bf16 where the
# plain version rounds normalised ones, and sum in another order. Each limit
# is about 4x the readings of H100 runs at these shapes (in brackets; K1/K2
# at dropout 0 and 0.1; K7-K10 without and with dropout).
OUT_TOL = 2e-2      # K1 out, max |kernel - plain| / max |plain|  [4.9e-3, 4.4e-3]
DQKV_TOL = 6e-3     # K2 dqkv, same measure                       [1.5e-3, 1.4e-3]
# the qkv-bias gradient is bf16: one ulp of its largest entry is 3.9e-3 of it
DB_TOL = 8e-3       # K2 qkv-bias gradient, same measure          [9.5e-4, 1.9e-3]
STATS_TOL = 1e-5    # K1 fp32 softmax statistics, absolute        [9.5e-7, 9.5e-7]
# K4-K6 sum the same fp32 products of bf16 operands in another order
XENT_TOL = 3e-5     # K4 nll and lse, absolute                    [7.6e-6, 1.9e-6]
ARGMAX_MARGIN = 1e-3  # K4 argmax must equal the plain one where the plain top-2 gap exceeds this
DX_TOL = 1.2e-2     # K5 dx (bf16), max |kernel - plain| / max |plain|  [2.8e-3]
DE_TOL = 1.8e-2     # K6 d embedding (bf16), same measure         [4.4e-3]
DBIAS_TOL = 2e-6    # K6 d bias (fp32), same measure              [4.3e-7]
# K7-K10 compute the same fp32 values in another order (rsqrtf, shuffle
# sums) and round y, dx, dres to bf16 once
LN_Y_TOL = 1e-2     # K7/K9 y, K8/K10 dx and dres (bf16), max |kernel - plain| / max |plain|
                    #   [y 2.6e-3, 2.6e-3; dx, dres 1.8e-3, 1.9e-3]
LN_STAT_TOL = 5e-7  # K7/K9 mu and rstd (fp32), absolute       [1.2e-7, 1.2e-7]
LN_DW_TOL = 1.2e-6  # K8/K10 dscale, dbias (fp32), relative    [3.1e-7, 2.4e-7]
# K11-K14 against their plain versions at the main path's shapes, each
# limit about 4x the H100 readings in brackets (dropout 0 and 0.1):
HM_OUT_TOL = 1.6e-2  # K11 out, max |kernel - plain| / max |plain|  [4.0e-3, 3.6e-3]
HM_DQKV_TOL = 8e-3   # K12 dqkv, same measure                       [1.9e-3, 1.7e-3]
SP_OUT_TOL = 8e-3    # K13 out, same measure (normalised p on both) [2.0e-3, 9.0e-4]
SP_DQKV_TOL = 8e-3   # K14 dqkv, same measure                       [1.9e-3, 1.7e-3]
SP_CHAIN_TOL = 8e-3  # K14 fed K13's own probs and out, against the plain chain  [1.9e-3, 1.7e-3]
# K13/K14's first design (mma.sync, a block per 64-row tile, before the
# Hopper redesign) at the main path's shapes, dropout 0.1: the least and
# largest kernel times of this script's earlier runs on an NVIDIA H100 80GB
# HBM3 at 700 W
SP_FIRST_DESIGN_MS = {"packed_attention_sp_fwd": (0.6238, 0.6297), "packed_attention_sp_bwd": (1.7857, 1.7971)}
# K11/K12's first design likewise (mma.sync, a block per 64-query tile), the
# least and largest of this script's earlier readings on that card
HM_FIRST_DESIGN_MS = {"heads_major_attention_fwd": (0.4740, 0.4814), "heads_major_attention_bwd": (1.2044, 1.2168)}
# K4-K6's first design likewise (mma.sync; K4 64 rows a block, K5/K6 32-row
# / 32-vocabulary-row blocks; synchronous copies) at the main path's shapes,
# width 768
XENT_FIRST_DESIGN_MS = {"mlm_xent_fwd": (1.4999, 1.5268), "mlm_xent_dx": (2.8493, 2.8914),
                        "mlm_xent_de": (2.3475, 2.3708)}
# K9/K10's first design likewise (K10 regenerating its mask with Philox, a
# warp a row with no copies in flight, 128 registers) at the main path's
# rows, bf16, rate 0.1
LN_FIRST_DESIGN_MS = {"dropout_add_layer_norm_fwd": (0.0550, 0.0568), "dropout_add_layer_norm_bwd": (0.1382, 0.1403)}
# K13's probabilities are bf16, rounded from fp32 values that agree with the
# plain version's to a few fp32 ulps: each entry may round to the other
# neighbour, so it must lie within one bf16 ulp of its own plain value
PROBS_ULPS = 1
# K15/K16 (every attention experiment variant) against their plain versions
# by K1/K2's measures, each limit about 4x the largest H100 reading over the
# variants (in brackets; dropout 0 and 0.1)
EXP_OUT_TOL = 2e-2     # out, max |kernel - plain| / max |plain|  [4.9e-3, 4.4e-3]
EXP_STATS_TOL = 8e-6   # stats, absolute                       [1.9e-6 prescale, 9.5e-7 the rest]
EXP_DQKV_TOL = 1.1e-2  # dqkv, as out              [1.5e-3, 1.4e-3; 2.7e-3 fdrop_prescale at 0.1]
EXP_DB_TOL = 8e-3      # the qkv-bias gradient, as out          [9.5e-4, 1.9e-3]
# K15/K16's first design (mma.sync, K1/K2's first tile code inside the
# variants' loops) at the main path's shapes, dropout 0.1, K15 "base" and
# K16 at hg = 6: the least and largest of this script's earlier readings on
# an NVIDIA H100 80GB HBM3 at 700 W
EXP_FIRST_DESIGN_MS = {"attn_exp_fwd": (0.7859, 0.8029), "attn_exp_bwd": (1.9802, 2.0180),
                       "attn_hgrid_fwd": (0.4891, 0.4997), "attn_hgrid_bwd": (1.2654, 1.2776)}
SLICE_REL_TOL = 2e-2  # kernel paths vs einsum + unfused path loss, bf16 model
# K1/K2 and K4-K6 in their other forms against their plain versions: fp16
# and bf16 at a padded or 128 head dim or a padded width are held to the
# bf16 limits above (fp16 keeps 3 more mantissa bits than bf16); fp32 only
# sums in another order than its plain version
F32_REL_TOL = 1e-4   # fp32 out, dqkv, dqkv_bias, dx, dE, db: max |kernel - plain| / max |plain|
F32_ABS_TOL = 1e-4   # fp32 stats, nll and lse, absolute
SLICE_F32_REL_TOL = 1e-4  # the dropout-off loss check in fp32
# the forms of phase 3: (dtype, head dim) of K1/K2 at the main path's B, T
# and 12 heads; (dtype, width) of K4-K6 at its N and V
ATTENTION_FORMS = (("float16", 64), ("float32", 64), ("bfloat16", 16), ("float16", 16), ("float32", 16),
                   ("bfloat16", 128), ("float16", 128), ("float32", 128), ("bfloat16", 32), ("float16", 32))
# K2 at D = 16 and K12, K13 and K14 at D = 16 and 32 on the route that
# zero-padded the heads to 64, K2 at D = 128 on its passes that held a
# head's rows (one warpgroup a block), and K1/K11's fp32 forward of the
# first design (a block a pair, 32-key tiles), at ATTENTION_FORMS' shapes,
# dropout 0.1: this script's last readings of them on an NVIDIA H100 80GB
# HBM3 at 700 W, each printed beside its redesign
EARLIER_DESIGN_MS = {("packed_attention_bwd", "bfloat16", 16): 1.1397, ("packed_attention_bwd", "float16", 16): 1.1122,
                     ("packed_attention_fwd", "float32", 16): 1.5734, ("packed_attention_fwd", "float32", 64): 2.6246,
                     ("packed_attention_fwd", "float32", 128): 3.8901,
                     ("heads_major_attention_fwd", "float32", 16): 1.5450,
                     ("heads_major_attention_fwd", "float32", 64): 2.5727,
                     ("heads_major_attention_fwd", "float32", 128): 3.8412,
                     ("heads_major_attention_bwd", "bfloat16", 16): 0.9748,
                     ("heads_major_attention_bwd", "float16", 16): 0.9798,
                     ("heads_major_attention_bwd", "bfloat16", 32): 1.0790,
                     ("heads_major_attention_bwd", "float16", 32): 1.0786,
                     ("packed_attention_sp_bwd", "bfloat16", 16): 0.9555,
                     ("packed_attention_sp_bwd", "float16", 16): 0.9592,
                     ("packed_attention_sp_bwd", "bfloat16", 32): 1.0496,
                     ("packed_attention_sp_bwd", "float16", 32): 1.0530,
                     ("packed_attention_sp_fwd", "bfloat16", 16): 0.4706,
                     ("packed_attention_sp_fwd", "float16", 16): 0.4814,
                     ("packed_attention_sp_fwd", "bfloat16", 32): 0.5162,
                     ("packed_attention_sp_fwd", "float16", 32): 0.5265,
                     ("packed_attention_bwd", "bfloat16", 128): 2.1757,
                     ("packed_attention_bwd", "float16", 128): 2.0320,
                     # K5/K6 at width 1024 on the form that owned 512 columns a block and formed the
                     # logits twice: bf16 this script's reading, fp16 tools/xent_steps.py --h1024's of
                     # that build in the same call as the 1024 form (best of its rounds)
                     ("mlm_xent_dx", "bfloat16", 1024): 3.0922, ("mlm_xent_de", "bfloat16", 1024): 3.0881,
                     ("mlm_xent_dx", "float16", 1024): 2.9448, ("mlm_xent_de", "float16", 1024): 3.0209}
# K2 at D = 128 is also held at this T (B = 8, 12 heads), past 256, the
# limit its passes had while they held a head's rows in shared memory
STREAMED_LONG_T = 512
XENT_FORMS = (("bfloat16", 128), ("bfloat16", 256), ("bfloat16", 512), ("float16", 768), ("float32", 768),
              ("bfloat16", 1024), ("bfloat16", 384), ("float16", 384), ("bfloat16", 2048), ("bfloat16", 2560),
              ("float16", 2048), ("float16", 2560), ("float32", 1088), ("float32", 2048), ("float16", 1024))
# K11-K14 take the forms of ATTENTION_FORMS; K7-K10 at the main path's rows
# in these (dtype, width) forms: below 64 and odd widths on the element
# forms, above 1024 on the block forms (Megatron-BERT's 2048, ALBERT-
# xxlarge's 4096)
LN_FORMS = (("bfloat16", 64), ("bfloat16", 100), ("float32", 100), ("bfloat16", 1030), ("bfloat16", 2048),
            ("float16", 2048), ("float32", 4096))
# the geometry phase: (label, fields over coco_pretrain.json's model block);
# each trains GEOMETRY_EXAMPLES / 128 steps
GEOMETRY_EXAMPLES = 384
GEOMETRIES = (
    ("the JAX package's tiny (fp32, D=16, H=64), all four kernel flags",
     dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=128, dtype="float32", use_fused_layer_norm=True)),
    ("bert-base in fp16", dict(dtype="float16")),
    ("BERT-Small (L=4, H=512, A=8, I=2048) in bf16",
     dict(hidden_size=512, num_hidden_layers=4, num_attention_heads=8, intermediate_size=2048)),
    ("bert-base in fp16, packed_qkv false, the fused LayerNorm",
     dict(dtype="float16", packed_qkv=False, use_fused_layer_norm=True)),
    ("the JAX package's tiny (fp32, D=16, H=64), flash_save_probs, the fused LayerNorm",
     dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=128, dtype="float32", use_fused_layer_norm=True, flash_save_probs=True)),
    # depth cut from 24 to 2 layers to fit the phase's time; widths as published
    ("Megatron-BERT 1.3B's widths (Shoeybi et al. 2019, Table 4: H=2048, A=32, I=8192) at L=2 (cut from 24) in "
     "bf16, the fused LayerNorm, fast_dropout and the fused cross-entropy (K4-K6 on the wide form)",
     dict(hidden_size=2048, num_hidden_layers=2, num_attention_heads=32, intermediate_size=8192,
          use_fused_layer_norm=True, fast_dropout=True, fused_mlm_xent=True)),
    # the reference trains in fp32 unless apex's fp16 is on: its numerics on the fp32 kernels
    ("bert-base in fp32", dict(dtype="float32")),
    ("bert-base in fp32, flash_save_probs", dict(dtype="float32", flash_save_probs=True)),
    # Megatron-BERT trained in fp16 mixed precision: its widths with K4-K6 on the fp16 wide form
    ("Megatron-BERT 1.3B's widths (Shoeybi et al. 2019, Table 4: H=2048, A=32, I=8192) at L=2 (cut from 24) in "
     "fp16, the fused LayerNorm, fast_dropout and the fused cross-entropy (K4-K6 on the wide form)",
     dict(hidden_size=2048, num_hidden_layers=2, num_attention_heads=32, intermediate_size=8192, dtype="float16",
          use_fused_layer_norm=True, fast_dropout=True, fused_mlm_xent=True)),
    # heads of 26 (312 / 12): K2 on its "bf16 D32" form, K1 padded to 64
    ("TinyBERT-4 (Jiao et al. 2020: L=4, H=312, A=12, I=1200) in bf16",
     dict(hidden_size=312, num_hidden_layers=4, num_attention_heads=12, intermediate_size=1200)),
    # the same heads through the other attention pairs: K12 / K13 / K14 on "bf16 D32", K11 padded to 64
    ("TinyBERT-4 in bf16, packed_qkv false",
     dict(hidden_size=312, num_hidden_layers=4, num_attention_heads=12, intermediate_size=1200, packed_qkv=False)),
    ("TinyBERT-4 in bf16, flash_save_probs",
     dict(hidden_size=312, num_hidden_layers=4, num_attention_heads=12, intermediate_size=1200,
          flash_save_probs=True)),
    # depth cut from 24 to 2 layers, as the Megatron runs; widths as VisualBertConfig.large ships them
    ("bert-large's widths (VisualBertConfig.large: H=1024, A=16, I=4096) at L=2 (cut from 24) in bf16, the fused "
     "LayerNorm, fast_dropout and the fused cross-entropy (K5/K6 on the 1024 form)",
     dict(hidden_size=1024, num_hidden_layers=2, num_attention_heads=16, intermediate_size=4096,
          use_fused_layer_norm=True, fast_dropout=True, fused_mlm_xent=True)),
)
F32_GEOMETRY, F32_SP_GEOMETRY = 6, 7  # the bert-base fp32 runs: the fp32 rows' launches
F16_WIDE_GEOMETRY = 8  # the Megatron-width fp16 run: the fp16 wide K4-K6 rows' launches
TINYBERT_GEOMETRY = 9  # the TinyBERT-4 run: K2's "bf16 D32" row's launches
TINYBERT_HM_GEOMETRY, TINYBERT_SP_GEOMETRY = 10, 11  # K12's and K13/K14's "bf16 D32" rows' launches
BERT_LARGE_GEOMETRY = 12  # the bert-large run: K5/K6's "bf16 H1024" rows' launches
BERT_BASE_F32_STEP_MS = 525.42  # phase 27's bert-base fp32 median step on the first-design K1 forward (H100, 700 W)
# the kernel table's rows of the fp32 kernels: (row name, wrapper module,
# wrapper, source, the TPU kernel it replaces); launches from the bert-base
# fp32 run
F32_KERNELS = (
    ("packed_attention_fwd (fp32)", "flash_attention", "packed_attention_fwd", "flash_attention_f32.cu",
     "visualbert_tpu/ops/flash_attention.py:249"),
    ("packed_attention_bwd (fp32)", "flash_attention", "packed_attention_bwd", "flash_attention_f32.cu",
     "visualbert_tpu/ops/flash_attention.py:307"),
    ("mlm_xent_fwd (fp32)", "mlm_xent", "mlm_xent_fwd", "mlm_xent_f32.cu", "visualbert_tpu/ops/mlm_xent.py:52"),
    ("mlm_xent_dx (fp32)", "mlm_xent", "mlm_xent_dx", "mlm_xent_f32.cu", "visualbert_tpu/ops/mlm_xent.py:145"),
    ("mlm_xent_de (fp32)", "mlm_xent", "mlm_xent_de", "mlm_xent_f32.cu", "visualbert_tpu/ops/mlm_xent.py:170"),
)
# the kernel table's rows of K4-K14's forms that phase 27 drives: (row name,
# wrapper module, wrapper, source, the TPU kernel it replaces, the geometry
# whose run gives its launches, the phase-3 form whose numbers it takes)
FORM_KERNELS = (
    ("packed_attention_bwd (bf16 D32)", "flash_attention", "packed_attention_bwd", "flash_attention_packed.cu",
     "visualbert_tpu/ops/flash_attention.py:307", TINYBERT_GEOMETRY, ("bfloat16", 32)),
    ("heads_major_attention_bwd (bf16 D32)", "flash_attention", "heads_major_attention_bwd", "flash_attention.cu",
     "visualbert_tpu/ops/flash_attention.py:93", TINYBERT_HM_GEOMETRY, ("bfloat16", 32)),
    ("packed_attention_sp_bwd (bf16 D32)", "flash_attention", "packed_attention_sp_bwd", "flash_attention_sp.cu",
     "visualbert_tpu/ops/flash_attention.py:441", TINYBERT_SP_GEOMETRY, ("bfloat16", 32)),
    ("packed_attention_sp_fwd (bf16 D32)", "flash_attention", "packed_attention_sp_fwd", "flash_attention_sp.cu",
     "visualbert_tpu/ops/flash_attention.py:409", TINYBERT_SP_GEOMETRY, ("bfloat16", 32)),
    ("heads_major_attention_fwd (fp16 D64)", "flash_attention", "heads_major_attention_fwd", "flash_attention.cu",
     "visualbert_tpu/ops/flash_attention.py:71", 3, ("float16", 64)),
    ("heads_major_attention_bwd (fp16 D64)", "flash_attention", "heads_major_attention_bwd", "flash_attention.cu",
     "visualbert_tpu/ops/flash_attention.py:93", 3, ("float16", 64)),
    ("packed_attention_sp_fwd (fp32)", "flash_attention", "packed_attention_sp_fwd", "flash_attention_f32.cu",
     "visualbert_tpu/ops/flash_attention.py:409", F32_SP_GEOMETRY, ("float32", 64)),
    ("packed_attention_sp_bwd (fp32)", "flash_attention", "packed_attention_sp_bwd", "flash_attention_f32.cu",
     "visualbert_tpu/ops/flash_attention.py:441", F32_SP_GEOMETRY, ("float32", 64)),
    ("dropout_add_layer_norm_fwd (bf16 block, 16-byte)", "layer_norm", "dropout_add_layer_norm_fwd",
     "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:171", 5, ("bfloat16", 2048)),
    ("dropout_add_layer_norm_bwd (bf16 block, 16-byte)", "layer_norm", "dropout_add_layer_norm_bwd",
     "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:189", 5, ("bfloat16", 2048)),
    ("mlm_xent_fwd (bf16 wide H2048)", "mlm_xent", "mlm_xent_fwd", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:52",
     5, ("bfloat16", 2048)),
    ("mlm_xent_dx (bf16 wide H2048)", "mlm_xent", "mlm_xent_dx", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:145",
     5, ("bfloat16", 2048)),
    ("mlm_xent_de (bf16 wide H2048)", "mlm_xent", "mlm_xent_de", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:170",
     5, ("bfloat16", 2048)),
    ("mlm_xent_fwd (fp16 wide H2048)", "mlm_xent", "mlm_xent_fwd", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:52",
     F16_WIDE_GEOMETRY, ("float16", 2048)),
    ("mlm_xent_dx (fp16 wide H2048)", "mlm_xent", "mlm_xent_dx", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:145",
     F16_WIDE_GEOMETRY, ("float16", 2048)),
    ("mlm_xent_de (fp16 wide H2048)", "mlm_xent", "mlm_xent_de", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:170",
     F16_WIDE_GEOMETRY, ("float16", 2048)),
    ("mlm_xent_dx (bf16 H1024)", "mlm_xent", "mlm_xent_dx", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:145",
     BERT_LARGE_GEOMETRY, ("bfloat16", 1024)),
    ("mlm_xent_de (bf16 H1024)", "mlm_xent", "mlm_xent_de", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:170",
     BERT_LARGE_GEOMETRY, ("bfloat16", 1024)),
)
# phase 25: the mesh's runs against the one-process run on the same seeded
# weights and batch (bf16 model; the ranks sum in another order), each limit
# about 4x the H100 readings in brackets ((2, 1), (1, 2))
MESH_STEPS = 2
MESH_DROPOUT_STEPS = 3
MESH_LOSS_TOL = 1e-4    # |loss - one-process loss| / one-process loss, every step  [2.4e-5, 2.2e-5]
# each parameter tensor's update (final - initial) against the one-process
# update: ||u_mesh - u_one|| / ||u_one||, the worst tensor; BertAdam turns
# bf16 rounding in a gradient near zero into a full-size step of either sign
MESH_UPDATE_TOL = 0.16  # [3.9e-2 token-type table, 3.3e-2 position table]
# dropout 0.1 on (1, 2): before the trainer's broadcast, each whole-held
# gradient on model rank 1 against model rank 0's, max |g1 - g0| / max |g0|,
# the worst tensor of every step (peers that drew different hidden-state
# masks would be apart by the gradient's own size; only the two token-type
# tables, whose embedding backward adds in no fixed order, are apart)
MESH_GRAD_GAP_TOL = 5e-6  # [1.24e-6, 1.04e-6, 8.0e-7 over the three steps]
# the cross-entropy's rows on a rank of either mesh: 64 pairs x 24
MESH_XENT_ROWS = 1536
# launches a step on every rank at dropout 0 (K1, K2, K4, K5, K6, K7, K8) and
# at dropout 0.1 (K1, K2, K4-K6, K9, K10, site forward and backward)
MESH_PER_STEP = {"K1": 12, "K2": 12, "K4": 1, "K5": 1, "K6": 1, "K7": 24, "K8": 24, "K9": 0, "K10": 0,
                 "K3 site fwd": 0, "K3 site bwd": 0}
MESH_DROPOUT_PER_STEP = dict(MESH_PER_STEP, K7=0, K8=0, K9=24, K10=24, **{"K3 site fwd": 1, "K3 site bwd": 1})

KERNELS = (  # name, wrapper module, source, the TPU kernel it replaces
    ("packed_attention_fwd", "flash_attention", "flash_attention_packed.cu",
     "visualbert_tpu/ops/flash_attention.py:249"),
    ("packed_attention_bwd", "flash_attention", "flash_attention_packed.cu",
     "visualbert_tpu/ops/flash_attention.py:307"),
    ("dropout_mask", "dropout", "dropout.cu", "visualbert_tpu/ops/dropout.py:61"),
    ("mlm_xent_fwd", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:52"),
    ("mlm_xent_dx", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:145"),
    ("mlm_xent_de", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:170"),
    ("add_layer_norm_fwd", "layer_norm", "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:28"),
    ("add_layer_norm_bwd", "layer_norm", "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:40"),
    ("dropout_add_layer_norm_fwd", "layer_norm", "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:171"),
    ("dropout_add_layer_norm_bwd", "layer_norm", "layer_norm.cu", "visualbert_tpu/ops/layer_norm.py:189"),
    ("heads_major_attention_fwd", "flash_attention", "flash_attention.cu", "visualbert_tpu/ops/flash_attention.py:71"),
    ("heads_major_attention_bwd", "flash_attention", "flash_attention.cu", "visualbert_tpu/ops/flash_attention.py:93"),
    ("packed_attention_sp_fwd", "flash_attention", "flash_attention_sp.cu",
     "visualbert_tpu/ops/flash_attention.py:409"),
    ("packed_attention_sp_bwd", "flash_attention", "flash_attention_sp.cu",
     "visualbert_tpu/ops/flash_attention.py:441"),
    ("attn_exp_fwd", "attention_exp", "flash_attention_exp.cu", "scripts/attn_exp.py:53"),
    ("attn_exp_bwd", "attention_exp", "flash_attention_exp.cu", "scripts/attn_exp.py:100"),
    ("attn_hgrid_fwd", "attention_exp", "flash_attention_exp.cu", "scripts/attn_hgrid.py:56"),
    ("attn_hgrid_bwd", "attention_exp", "flash_attention_exp.cu", "scripts/attn_hgrid.py:90"),
    ("dropout_fwd", "dropout", "dropout.cu", "visualbert_tpu/ops/dropout.py:61"),
    ("dropout_bwd", "dropout", "dropout.cu", "visualbert_tpu/ops/dropout.py:61"),
)
LABELS = (["K1", "K2", "K3 mask"] + [f"K{i + 1}" for i in range(3, 14)] + ["K15 fwd", "K15 bwd", "K16 fwd", "K16 bwd"]
          + ["K3 site fwd", "K3 site bwd"])
# launches of K1..K14, K15/K16's forward and backward and the dropout site's
# forward and backward (K3's body) per train step (12 layers) or eval batch:
# nothing on them runs K15/K16, and no path launches K3's mask since the
# site kernels took its place (each fast_dropout site: one forward, one
# backward; as shipped 25 sites a step, the embeddings' and two a layer)
PER_STEP = (12, 12, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 25, 25)            # the config as shipped
FUSED_PER_STEP = (12, 12, 0, 1, 1, 1, 0, 0, 24, 24, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1)     # with use_fused_layer_norm
NO_DROPOUT_PER_STEP = (12, 12, 0, 1, 1, 1, 24, 24, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)  # that, both dropout rates 0
HEADS_MAJOR_PER_STEP = (0, 0, 0, 1, 1, 1, 0, 0, 24, 24, 12, 12, 0, 0, 0, 0, 0, 0, 1, 1)  # fused LN, packed_qkv false
SAVE_PROBS_PER_STEP = (0, 0, 0, 1, 1, 1, 0, 0, 24, 24, 0, 0, 12, 12, 0, 0, 0, 0, 1, 1)   # fused LN, flash_save_probs
VQA_TRAIN_PER_STEP = (12, 12, 0, 0, 0, 0, 0, 0, 24, 24, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1)
VQA_EVAL_PER_BATCH = (12, 0, 0, 0, 0, 0, 24, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
NLVR2_TRAIN_PER_STEP = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12, 12, 0, 0, 0, 0, 25, 25)
NLVR2_EVAL_PER_BATCH = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12, 0, 0, 0, 0, 0, 0, 0)
VQA_ADVANCED_TRAIN_PER_STEP = FUSED_PER_STEP  # the fused cross-entropy in training; evaluation as VQA's
FLICKR_TRAIN_PER_STEP = (12, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 25, 25)
FLICKR_EVAL_PER_BATCH = (12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
# configs/vcr_finetune_qa.json's model block: no fused LayerNorm, no fused
# cross-entropy; the detector runs no kernel of the port
VCR_TRAIN_PER_STEP = (12, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 25, 25)
VCR_EVAL_PER_BATCH = (12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
# vcr_coco_pretrain with configs/coco_pretrain.json's model block: the main
# path's kernels; its evaluation decodes through the fused forward (K4)
VCR_COCO_TRAIN_PER_STEP = PER_STEP
VCR_COCO_EVAL_PER_BATCH = (12, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
# the unsupervised step (either source): 24 sites, the embeddings' dropout
# being a stock one; its evaluation runs the fused cross-entropy's forward
UNSUP_PER_STEP = (12, 12, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 24)
UNSUP_IMAGE_PER_STEP = (12, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 24)  # no text: no K4-K6
# the end-to-end step: the encoder's 24 sites (its embeddings' dropout and
# the detector's are stock dropout), K4-K6 over every text row
E2E_PER_STEP = UNSUP_PER_STEP
UNSUP_EVAL_PER_BATCH = VCR_COCO_EVAL_PER_BATCH
TEXT_PRETRAIN_PER_STEP = PER_STEP
UNSUP_VQA_TRAIN_PER_STEP = (12, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 24)
UNSUP_VQA_EVAL_PER_BATCH = FLICKR_EVAL_PER_BATCH
# the as-shipped step's peak memory before the site kernels, when each site
# saved a bf16 multiplier (this script's last run before them, on an NVIDIA
# H100 80GB HBM3 at 700 W)
SHIPPED_PEAK_GIB_BEFORE = 14.43
# the card's peaks (NVIDIA's H100 SXM data sheet, dense): a kernel's bound is
# the larger of its bytes over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12      # outside the tensor cores
# K3's Philox work, three readings (times the SMs and the card's largest SM
# clock, nvidia-smi): PHILOX_INSTRUCTIONS a call (a round's two
# 32x32->64-bit multiplies, one IMAD.WIDE each, and its two three-input xors,
# one LOP3 each; the key schedule runs on (seed, 0), the same in every
# thread, so it is uniform or folded) at the SM's issue rate, four warp
# schedulers of one instruction a clock (128 a clock an SM; NVIDIA's H100
# architecture whitepaper), and at the CUDA C++ Programming Guide's 64
# results a clock an SM for 32-bit integer multiply-add and for bitwise work
# (compute capability 9.0) on one pipe; and K3's own calls at the rate
# csrc/bench/philox_rate.cu measures on K3's counter form, which is the
# bound's reading
PHILOX_INSTRUCTIONS = 10 * (2 + 2)
ISSUE_PER_SM_CLOCK = 4 * 32
INT32_OPS_PER_SM_CLOCK = 64
# fp32 operations per element of K7-K10 (add, two-pass statistics, affine;
# the backward's recompute, the two row means and the parameter sums;
# dropout's division and select)
LN_OPS = {"add_layer_norm_fwd": 9, "dropout_add_layer_norm_fwd": 11,
          "add_layer_norm_bwd": 16, "dropout_add_layer_norm_bwd": 19}


def log(msg):
    print(msg, flush=True)


def max_sm_hz():
    """The card's largest SM clock, as nvidia-smi reports it, in Hz."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def counters():
    """The launch-counting wrappers of K1..K14 and K15/K16's four."""
    import importlib

    return [getattr(importlib.import_module(f"visualbert_torch.ops.{mod}"), name) for name, mod, _, _ in KERNELS]


def read_launches():
    return [c.launches for c in counters()]


def launch_text(launches):
    return ", ".join(f"{label} {n}" for label, n in zip(LABELS, launches))


def zero_launches():
    for c in counters():
        c.launches = 0
        if hasattr(c, "forms"):
            c.forms.clear()


def read_forms():
    """{wrapper name: {form: launches}} of the wrappers that count forms (K1,
    K2, K4-K6)."""
    return {name: dict(c.forms) for (name, _, _, _), c in zip(KERNELS, counters()) if hasattr(c, "forms")}


def cuda_time_ms(fn, iters):
    from visualbert_torch.tools.main_path import cuda_ms

    return cuda_ms(fn, iters)


def host_us_a_call(torch, fn, iters):
    """The host's time a call of fn, enqueueing only (the card is idle
    first and nothing waits for it inside the loop), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()), float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes, ops, peak):
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger (ms, and which)."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def row_line(name, r, card):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    return (f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound  [{card}]")


def packed_inputs(torch):
    """K1/K2's inputs at the main path's shapes on the card
    (tools/main_path.py::packed_attention_inputs)."""
    from visualbert_torch.tools.main_path import packed_attention_inputs

    return packed_attention_inputs(torch.device("cuda"))


def check_dropout(torch, card):
    """K3 (the keep mask) and the dropout site's two kernels against their
    plain versions on the card. K3 at the main path's hidden-state shape:
    int8 and bf16 bit for bit with its twin, the same mask for the same seed
    and another for another, the keep rate within 4 sigma. The site forward
    and backward at that shape, at NLVR2's [64, 272, 768] and at the VCR
    step's [VCR_ROWS, VCR_T, 768], bf16, rate
    0.1: y, the bits and dx bit for bit with the plain versions (y where the
    plain y is not NaN, and NaN where it is), the keep rate within 4 sigma,
    and a NaN planted in x at a dropped position NaN in y. Times at the main
    path's shape: each kernel launched directly on preallocated tensors
    (the wrappers' host time a call printed beside it), the plain versions,
    and one library call of the same function, never on the path: K3
    bernoulli_ on an int8 tensor, the forward F.dropout, the backward
    aten.native_dropout_backward on F.dropout's mask. Bounds: K3 the larger
    of its mask's bytes and its Philox calls at the rate
    csrc/bench/philox_rate.cu measures on K3's counter form; the forward the
    larger of its bytes (x, y, the bits) and the same calls; the backward its
    bytes (dy, the bits, dx). Returns the three rows."""
    import torch.nn.functional as F

    from visualbert_torch.ops import _build
    from visualbert_torch.ops import dropout as dr
    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.main_path import B, TT, TV

    dev = torch.device("cuda")
    lib = _build.library()
    sms = _build.sm_count(dev)
    rate, seed = 0.1, 1234
    shape = (B, TT + TV, 768)
    rows = {}

    def keep_ok(share, n):
        return abs(share - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5

    # K3
    got = dr.dropout_mask(shape, rate, seed, torch.int8, dev)
    want = dr.dropout_mask_reference(shape, rate, seed, torch.int8, dev)
    same_bf16 = torch.equal(dr.dropout_mask(shape, rate, seed, torch.bfloat16, dev),
                            dr.dropout_mask_reference(shape, rate, seed, torch.bfloat16, dev))
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    keep = float(got.float().mean())
    n = got.numel()
    same = torch.equal(got, dr.dropout_mask(shape, rate, seed, torch.int8, dev))
    differ = not torch.equal(got, dr.dropout_mask(shape, rate, seed + 1, torch.int8, dev))
    log(f"K3 dropout mask {list(shape)}: int8 max_abs_err {err} (tol 0, bit-exact twin), bf16 mask equal: "
        f"{same_bf16}; keep rate {keep:.6f} (within 4 sigma of {1 - rate}: {keep_ok(keep, n)}); same seed same "
        f"mask {same}; new seed new mask {differ}  [{card}]")
    if err != 0 or not same_bf16 or not keep_ok(keep, n) or not same or not differ:
        raise SystemExit("K3 disagrees with its plain version")
    del want

    # the site forward and backward at the main path's, NLVR2's and the VCR step's shapes
    errs = {"dropout_fwd": 0.0, "dropout_bwd": 0.0}
    for shp in (shape, (64, 272, 768), (VCR_ROWS, VCR_T, 768), (UNSUP_ROWS, UNSUP_VL_T, 768),
                (UNSUP_ROWS, UNSUP_TEXT_T, 768), (UNSUP_ROWS, UNSUP_IMAGE_T, 768), (E2E_ROWS, UNSUP_VL_T, 768)):
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
        m = x.numel()
        keep_r = dr.dropout_mask_reference(shp, rate, seed, torch.int8, dev).reshape(-1)
        dropped = int(torch.nonzero(keep_r == 0)[0, 0])
        del keep_r
        x.view(-1)[dropped] = float("nan")
        y, bits = dr.dropout_fwd(x, rate, seed)
        y_r, bits_r = dr.dropout_fwd_reference(x, rate, seed)
        dx = dr.dropout_bwd(dy, bits, rate)
        dx_r = dr.dropout_bwd_reference(dy, bits_r, rate)
        torch.cuda.synchronize()
        nan_r = torch.isnan(y_r)
        same_y = (torch.equal(torch.isnan(y), nan_r)
                  and torch.equal(y.view(torch.int16)[~nan_r], y_r.view(torch.int16)[~nan_r]))
        same_bits = torch.equal(bits, bits_r)
        same_dx = torch.equal(dx.view(torch.int16), dx_r.view(torch.int16))
        nan_stays = bool(torch.isnan(y.view(-1)[dropped]))
        share = float(dr.unpack_keep(bits, m).float().mean())
        errs["dropout_fwd"] = max(errs["dropout_fwd"], float((y.float() - y_r.float())[~nan_r].abs().max()))
        errs["dropout_bwd"] = max(errs["dropout_bwd"], float((dx.float() - dx_r.float()).abs().max()))
        log(f"K3 site {list(shp)} bf16 rate {rate}: y bit for bit {same_y}, bits [{bits.numel()}] uint8 equal "
            f"{same_bits}, dx bit for bit {same_dx}; a NaN at dropped element {dropped} NaN in y: {nan_stays}; "
            f"keep rate {share:.6f} (within 4 sigma: {keep_ok(share, m)})  [{card}]")
        if not (same_y and same_bits and same_dx and nan_stays and keep_ok(share, m)):
            raise SystemExit(f"the dropout site kernels disagree with their plain versions at {list(shp)}")
        del x, dy, y, y_r, dx, dx_r, bits, bits_r

    # times at the main path's shape
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    out, y, dx = torch.empty(shape, dtype=torch.int8, device=dev), torch.empty_like(x), torch.empty_like(x)
    bits = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)
    launches = {"dropout_mask": lambda: dr.launch_mask(lib, out, rate, 7),
                "dropout_fwd": lambda: dr.launch_fwd(lib, x, y, bits, rate, 7),
                "dropout_bwd": lambda: dr.launch_bwd(lib, dy, bits, dx, rate)}
    for name, fn in launches.items():
        lib.check(fn(), name)
    plain = {"dropout_mask": lambda: dr.dropout_mask_reference(shape, rate, 7, torch.int8, dev),
             "dropout_fwd": lambda: dr.dropout_fwd_reference(x, rate, 7),
             "dropout_bwd": lambda: dr.dropout_bwd_reference(dy, bits, rate)}
    wrapped = {"dropout_mask": lambda: dr.dropout_mask(shape, rate, 7, torch.int8, dev),
               "dropout_fwd": lambda: dr.dropout_fwd(x, rate, 7),
               "dropout_bwd": lambda: dr.dropout_bwd(dy, bits, rate)}
    lib_keep = F.dropout(x, rate, training=True) != 0
    library = {"dropout_mask": lambda: torch.empty(shape, dtype=torch.int8, device=dev).bernoulli_(1 - rate),
               "dropout_fwd": lambda: F.dropout(x, rate, training=True),
               "dropout_bwd": lambda: torch.ops.aten.native_dropout_backward(dy, lib_keep, 1.0 / (1.0 - rate))}
    # the Philox calls (one a 4 elements) at the rate the card makes K3's
    calls, hz = -(-n // 4), max_sm_hz()
    k3_rate = attn_steps.philox_rate(attn_steps.build_philox_bench(), sms, card, "mask")
    clocks = calls / 32 / (sms * attn_steps.SUB_PARTITIONS) * k3_rate["cycles_per_warp_call"]
    moved = {"dropout_mask": nbytes(out), "dropout_fwd": nbytes(x, y, bits), "dropout_bwd": nbytes(dy, bits, dx)}
    work = {"dropout_mask": (clocks, hz), "dropout_fwd": (clocks, hz), "dropout_bwd": (0, 1.0)}
    host_us = {}
    for name in launches:
        rows[name] = dict(max_abs_err=err if name == "dropout_mask" else errs[name],
                          ms=cuda_time_ms(launches[name], 50), plain_ms=cuda_time_ms(plain[name], 5),
                          library_ms=cuda_time_ms(library[name], 50), **bound(moved[name], *work[name]))
        host_us[name] = host_us_a_call(torch, wrapped[name], 50)
    count_ms = {r: calls * PHILOX_INSTRUCTIONS / (r * sms * hz) * 1e3 for r in (ISSUE_PER_SM_CLOCK,
                                                                                INT32_OPS_PER_SM_CLOCK)}
    log(f"K3's bound: its bytes {moved['dropout_mask'] / HBM_BYTES_PER_S * 1e3:.4f} ms; its {calls} Philox calls "
        f"at {hz / 1e6:.0f} MHz: x {PHILOX_INSTRUCTIONS} instructions at the issue rate ({ISSUE_PER_SM_CLOCK} a "
        f"clock an SM) {count_ms[ISSUE_PER_SM_CLOCK]:.4f} ms, at the guide's {INT32_OPS_PER_SM_CLOCK} a clock an SM "
        f"{count_ms[INT32_OPS_PER_SM_CLOCK]:.4f} ms; at the measured rate of K3's counter form "
        f"({k3_rate['cycles_per_warp_call']:.2f} cycles a warp call a sub-partition) {clocks / hz * 1e3:.4f} ms, "
        f"the bound's reading: {rows['dropout_mask']['bound_ms']:.4f} ms; the site forward's bound: its "
        f"{moved['dropout_fwd'] / 1e6:.1f} MB {moved['dropout_fwd'] / HBM_BYTES_PER_S * 1e3:.4f} ms against the "
        f"same calls' {clocks / hz * 1e3:.4f} ms  [{card}]")
    for kernel, name, code in ((dr.MASK, "dropout_mask", 0), (dr.SITE_FWD, "dropout_fwd", 1),
                               (dr.SITE_BWD, "dropout_bwd", 1)):
        regs, local, smem, per_sm = (lib.vb_dropout_info(kernel, w, code) for w in range(4))
        r = rows[name]
        log(f"{name} {list(shape)}: {regs} registers a thread, {local} bytes of local memory, {per_sm} blocks an SM, "
            f"one group of 16 elements a thread ({-(-n // (16 * 256))} blocks of 256); "
            f"{r['ms']:.4f} ms, {moved[name] / r['ms'] / 1e9:.3f} TB/s; the wrapper's host time "
            f"{host_us[name]:.1f} us a call (enqueue only)  [{card}]")
        if local:
            raise SystemExit(f"{name} spills to local memory")
    for name in launches:
        log(row_line(name, rows[name], card))
    del x, dy, out, y, dx, bits
    for where, shp in (("the unsupervised step's", (UNSUP_ROWS, UNSUP_VL_T, 768)),
                       ("the unsupervised step's", (UNSUP_ROWS, UNSUP_TEXT_T, 768)),
                       ("the unsupervised step's", (UNSUP_ROWS, UNSUP_IMAGE_T, 768)),
                       ("the end-to-end step's", (E2E_ROWS, UNSUP_VL_T, 768))):
        site_times_at(torch, card, lib, shp, rate, k3_rate, sms, hz, where)
    return rows


def site_times_at(torch, card, lib, shape, rate, k3_rate, sms, hz, where):
    """The site forward and backward at ``shape`` (bf16), launched on
    preallocated tensors, beside their plain versions, F.dropout /
    aten.native_dropout_backward and their bounds (the forward's bytes or
    its Philox calls at K3's measured rate, the backward's bytes)."""
    import torch.nn.functional as F

    from visualbert_torch.ops import dropout as dr
    from visualbert_torch.tools import attn_steps

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    n = x.numel()
    y, dx = torch.empty_like(x), torch.empty_like(x)
    bits = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)
    fwd, bwd = (lambda: dr.launch_fwd(lib, x, y, bits, rate, 7)), (lambda: dr.launch_bwd(lib, dy, bits, dx, rate))
    lib.check(fwd(), "dropout_fwd")
    lib.check(bwd(), "dropout_bwd")
    keep = F.dropout(x, rate, training=True) != 0
    clocks = -(-n // 4) / 32 / (sms * attn_steps.SUB_PARTITIONS) * k3_rate["cycles_per_warp_call"]
    rows = {
        "dropout_fwd": dict(ms=cuda_time_ms(fwd, 50),
                            plain_ms=cuda_time_ms(lambda: dr.dropout_fwd_reference(x, rate, 7), 5),
                            library_ms=cuda_time_ms(lambda: F.dropout(x, rate, training=True), 50),
                            **bound(nbytes(x, y, bits), clocks, hz)),
        "dropout_bwd": dict(ms=cuda_time_ms(bwd, 50),
                            plain_ms=cuda_time_ms(lambda: dr.dropout_bwd_reference(dy, bits, rate), 5),
                            library_ms=cuda_time_ms(
                                lambda: torch.ops.aten.native_dropout_backward(dy, keep, 1.0 / (1.0 - rate)), 50),
                            **bound(nbytes(dy, bits, dx), 0, 1.0)),
    }
    for name, r in rows.items():
        log(row_line(f"{name} at {where} {list(shape)}", r, card))


def check_kernels(torch, card):
    from visualbert_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rows = {}

    # K1, K2: packed attention at the main path's shapes, padded keys
    qkv, qb, key_bias, dout = packed_inputs(torch)
    B, T, F = qkv.shape
    H, D = 12, 64
    k1, k2 = dict(max_abs_err=0.0), dict(max_abs_err=0.0)
    for rate in (0.0, 0.1):
        out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
        dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
        dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
        torch.cuda.synchronize()
        e_out, r_out = rel_err(out, out_r)
        e_st = float((stats - stats_r).abs().max())
        e_dq, r_dq = rel_err(dqkv, dqkv_r)
        e_db, r_db = rel_err(dqb, dqb_r)
        log(f"K1 attention fwd rate {rate}: out max_abs_err {e_out:.3e} (rel {r_out:.3e}, tol {OUT_TOL}); "
            f"stats max_abs_err {e_st:.3e} (tol {STATS_TOL})")
        log(f"K2 attention bwd rate {rate}: dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, tol {DQKV_TOL}); "
            f"dqkv_bias max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DB_TOL})")
        if not (r_out <= OUT_TOL and e_st <= STATS_TOL and r_dq <= DQKV_TOL and r_db <= DB_TOL):
            raise SystemExit(f"K1/K2 disagree with their plain versions at rate {rate}")
        k1["max_abs_err"] = max(k1["max_abs_err"], e_out)
        k2["max_abs_err"] = max(k2["max_abs_err"], e_dq)
    del out_r, dqkv_r
    rate = 0.1  # the main path's attention dropout
    k1["ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 20)
    k1["plain_ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5), 3)
    k2["ms"] = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 20)
    k2["plain_ms"] = cuda_time_ms(
        lambda: fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 3)
    # without dropout: what Philox costs inside K1/K2
    k1_ms0 = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.0, 5), 20)
    k2_ms0 = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.0, 5), 20)
    # the library yardstick: scaled_dot_product_attention on [B, H, T, D]
    # views of the same biased qkv, the key bias as its mask, the same rate
    q, k, v = ((qkv + qb).view(B, T, H, 3, D).unbind(3))  # head-major [h, (q, k, v), d]
    k1["library_ms"], k2["library_ms"] = sdpa_ms(torch, *(t.transpose(1, 2) for t in (q, k, v)), key_bias,
                                                 dout.view(B, T, H, D).transpose(1, 2), rate)
    del q, k, v
    # useful FLOPs: QK^T and PV forward; the backward's dV, dP, dQ, dK (its
    # S recomputations, one per pass, are extra work not counted here)
    gflop = 2.0 * B * H * T * T * D / 1e9
    k1.update(bound(nbytes(qkv, qb, key_bias, out, stats), 2 * gflop * 1e9, BF16_FLOPS))
    k2.update(bound(nbytes(qkv, qb, key_bias, dout, out, stats, dqkv, dqb), 4 * gflop * 1e9, BF16_FLOPS))
    for name, k, n_mm, ms0 in (("packed_attention_fwd", k1, 2, k1_ms0), ("packed_attention_bwd", k2, 4, k2_ms0)):
        log(f"{name} [{B}, {T}, {F}] dropout {rate}: kernel {k['ms']:.4f} ms "
            f"({n_mm * gflop / k['ms']:.1f} TFLOP/s useful), plain {k['plain_ms']:.4f} ms; "
            f"dropout 0: kernel {ms0:.4f} ms  [{card}]")
    rows["packed_attention_fwd"], rows["packed_attention_bwd"] = k1, k2
    from visualbert_torch.ops import _build

    lib = _build.library()
    hgs = fa.packed_head_groups(lib, B, H, T, dev)
    for k, (kernel, hg) in enumerate(zip(fa.PACKED_KERNELS, hgs)):
        regs, local, smem, per_sm = (lib.vb_attn_packed_info(k, w, T) for w in range(4))
        log(f"K1/K2 {kernel}: hg {hg} ({B * H // hg} blocks of one batch row x {hg} heads), {per_sm} blocks an SM, "
            f"{regs} registers a thread, {local} bytes of local memory, {smem} bytes of shared memory at T={T}")
    for name in ("packed_attention_fwd", "packed_attention_bwd"):
        log(row_line(name, rows[name], card))
    return rows


def k16_twin(torch, rows, card):
    """K16 at K1/K2's own head groups is K1/K2's twin: the same tile code
    and sums on the same (batch row, hg heads) blocks, so out, stats and
    dqkv must equal K1/K2's bit for bit at dropout 0 and 0.1, and its times
    are printed beside K1/K2's in this call (dropout 0.1). Where K2's two
    passes take different hg, K16's backward at each is set beside K2
    launched with that hg in both passes. Then K1/K2 beside K16's best hg
    of this call (check_attention_experiments' times)."""
    from visualbert_torch.ops import _build
    from visualbert_torch.ops import attention_exp as ae
    from visualbert_torch.ops import flash_attention as fa

    qkv, qb, key_bias, dout = packed_inputs(torch)
    B, T, _ = qkv.shape
    H, rate = 12, 0.1
    lib = _build.library()
    hgs = fa.packed_head_groups(lib, B, H, T, qkv.device)
    for r in (0.0, rate):
        o1, s1 = fa.packed_attention_fwd(qkv, qb, key_bias, H, r, 6)
        d2, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout, o1, s1, H, r, 6)
        for hg in sorted(set(hgs)):
            o16, s16 = ae.attn_hgrid_fwd(qkv, qb, key_bias, H, r, 6, hg)
            d16, _ = ae.attn_hgrid_bwd(qkv, qb, key_bias, dout, o1, s1.view(s16.shape), H, r, 6, hg)
            torch.cuda.synchronize()
            same = (torch.equal(o16, o1), torch.equal(s16.view(s1.shape), s1), torch.equal(d16, d2))
            log(f"K16 at hg {hg} against K1/K2 (hg {hgs[0]} / {hgs[1]}, {hgs[2]}), dropout {r}: out, stats, dqkv bit "
                f"for bit: {same}")
            if not all(same):
                raise SystemExit(f"K16 at hg {hg} differs from K1/K2 at dropout {r}")
            del o16, s16, d16
        del d2
    out, stats = o1, s1
    k1, k2 = rows["packed_attention_fwd"], rows["packed_attention_bwd"]
    f16 = cuda_time_ms(lambda: ae.attn_hgrid_fwd(qkv, qb, key_bias, H, rate, 5, hgs[0]), 20)
    f1 = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 20)
    log(f"K1 {f1:.4f} ms and its twin K16 at hg {hgs[0]} {f16:.4f} ms ({f16 / f1 - 1:+.1%}; within 10 %: "
        f"{abs(f16 / f1 - 1) <= 0.10}), dropout {rate}  [{card}]")
    for hg in sorted(set(hgs[1:])):
        b16 = cuda_time_ms(lambda: ae.attn_hgrid_bwd(qkv, qb, key_bias, dout, out, stats.view(B, H // hg, hg, T), H,
                                                     rate, 5, hg), 20)
        if hgs[1] == hgs[2]:
            what, b2 = "K2", cuda_time_ms(
                lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 20)
        else:
            what, b2 = f"K2 at hg {hg} in both passes", cuda_time_ms(
                lambda: fa.launch_packed_bwd(lib, qkv, qb, key_bias, dout, out, stats, H, rate, 5, hg, hg), 20)
        log(f"{what} {b2:.4f} ms and its twin K16 at hg {hg} {b16:.4f} ms ({b16 / b2 - 1:+.1%}; within 10 %: "
            f"{abs(b16 / b2 - 1) <= 0.10}), dropout {rate}  [{card}]")
    for p, k in (("fwd", k1), ("bwd", k2)):
        name, ms = min(rows["attn_hgrid_" + p]["variant_ms"].items(), key=lambda kv: kv[1])
        log(f"K{1 if p == 'fwd' else 2} {p} {k['ms']:.4f} ms against K16 at its best {name} in this call "
            f"{ms:.4f} ms ({k['ms'] / ms:.1%}), dropout {rate}  [{card}]")


def sdpa_ms(torch, q, k, v, key_bias, dout, rate):
    """scaled_dot_product_attention's forward and backward times on
    [B, H, T, D] q, k, v with the key bias as its mask (the attention
    kernels' library yardstick; no path of the port calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_mask = key_bias.to(torch.bfloat16)[:, None, None, :]
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=attn_mask, dropout_p=rate), 20)
    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*leaves, attn_mask=attn_mask, dropout_p=rate)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), 20)
    return fwd, bwd


def bf16_ulps(torch, x):
    """One bf16 ulp at each entry of x, and at least 2^-126 (fp32's least
    normal value: below it a kernel may flush to zero)."""
    tiny = 2.0 ** -126
    _, e = torch.frexp(x.float().abs().clamp_min(tiny))  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8).clamp_min(tiny)


def check_attention_variants(torch, card):
    """K11/K12 (heads-major) and K13/K14 (saved probabilities) against their
    plain versions at the main path's shapes: B=128, T=228, H=12, D=64,
    bf16, padded keys, dropout 0 and 0.1; each backward gets the plain
    forward's outputs on both sides. Each of K13's probabilities must lie
    within one bf16 ulp of its plain value, and K14 fed K13's own
    probabilities and output must agree with the plain chain. Kernel and
    plain times at dropout 0.1; the library times are
    scaled_dot_product_attention's forward and backward on the same q, k, v."""
    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools.main_path import B, TT, TV

    H, D, T = 12, 64, TT + TV
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    qkv5 = torch.randn((B, 3, H, T, D), generator=g, device=dev).to(torch.bfloat16)  # heads-major, biased
    qkv = qkv5.permute(0, 3, 2, 1, 4).reshape(B, T, 3 * H * D)  # the same numbers packed head-major
    dout4 = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    dout = dout4.permute(0, 2, 1, 3).reshape(B, T, H * D)
    mask = torch.ones((B, T), device=dev)
    mask[::3, TT - 20:TT] = 0  # some padded text
    mask[1::4, T - 30:] = 0    # some padded regions
    key_bias = (1.0 - mask) * -10000.0
    rows = {name: dict(max_abs_err=0.0) for name in ("heads_major_attention_fwd", "heads_major_attention_bwd",
                                                     "packed_attention_sp_fwd", "packed_attention_sp_bwd")}
    for rate in (0.0, 0.1):
        out, stats = fa.heads_major_attention_fwd(qkv5, key_bias, rate, 99)
        out_r, stats_r = fa.heads_major_attention_fwd_reference(qkv5, key_bias, rate, 99)
        dq = fa.heads_major_attention_bwd(qkv5, key_bias, dout4, out_r, stats_r, rate, 99)
        dq_r = fa.heads_major_attention_bwd_reference(qkv5, key_bias, dout4, out_r, stats_r, rate, 99)
        torch.cuda.synchronize()
        e11, r11 = rel_err(out, out_r)
        e_st = float((stats - stats_r).abs().max())
        e12, r12 = rel_err(dq, dq_r)
        del out, stats, out_r, stats_r, dq, dq_r
        o13, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, 99)
        o13_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, 99)
        d14 = fa.packed_attention_sp_bwd(qkv, probs_r, dout, o13_r, H, rate, 99)
        d14_r = fa.packed_attention_sp_bwd_reference(qkv, probs_r, dout, o13_r, H, rate, 99)
        d14_own = fa.packed_attention_sp_bwd(qkv, probs, dout, o13, H, rate, 99)  # the kernels' own chain
        torch.cuda.synchronize()
        e13, r13 = rel_err(o13, o13_r)
        dp = (probs.float() - probs_r.float()).abs()
        e_p = float(dp.max())
        u_p = float((dp / bf16_ulps(torch, probs_r)).max())
        del dp
        e14, r14 = rel_err(d14, d14_r)
        e_ch, r_ch = rel_err(d14_own, d14_r)
        del o13, probs, o13_r, probs_r, d14, d14_r, d14_own
        log(f"K11 heads-major fwd rate {rate}: out max_abs_err {e11:.3e} (rel {r11:.3e}, tol {HM_OUT_TOL}); "
            f"stats max_abs_err {e_st:.3e} (tol {STATS_TOL})")
        log(f"K12 heads-major bwd rate {rate}: dqkv max_abs_err {e12:.3e} (rel {r12:.3e}, tol {HM_DQKV_TOL})")
        log(f"K13 save-probs fwd rate {rate}: out max_abs_err {e13:.3e} (rel {r13:.3e}, tol {SP_OUT_TOL}); "
            f"probs max_abs_err {e_p:.3e}, at most {u_p:g} bf16 ulps of the entry's plain value "
            f"(tol {PROBS_ULPS})")
        log(f"K14 save-probs bwd rate {rate}: dqkv max_abs_err {e14:.3e} (rel {r14:.3e}, tol {SP_DQKV_TOL}); "
            f"fed K13's probs and out: max_abs_err {e_ch:.3e} (rel {r_ch:.3e}, tol {SP_CHAIN_TOL})")
        if not (r11 <= HM_OUT_TOL and e_st <= STATS_TOL and r12 <= HM_DQKV_TOL and r13 <= SP_OUT_TOL
                and u_p <= PROBS_ULPS and r14 <= SP_DQKV_TOL and r_ch <= SP_CHAIN_TOL):
            raise SystemExit(f"K11-K14 disagree with their plain versions at rate {rate}")
        for name, e in zip(rows, (max(e11, e_st), e12, max(e13, e_p), e14)):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

    rate = 0.1  # the main path's attention dropout
    out, stats = fa.heads_major_attention_fwd(qkv5, key_bias, rate, 5)
    o13, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, 5)
    # K14 reads K13's probabilities in place: the main path never copies them
    ldp = fa.probs_layout(probs, B, H, T)
    log(f"K13's probabilities: a [{B}, {H}, {T}, {T}] view with row stride {ldp} (K13's layout: "
        f"{fa.probs_row_stride(T)}), read by K14 without a copy: {ldp == fa.probs_row_stride(T)}")
    if ldp != fa.probs_row_stride(T):
        raise SystemExit("K13's probabilities are not in the layout K14 reads in place")
    calls = {
        "heads_major_attention_fwd": lambda f: f(qkv5, key_bias, rate, 5),
        "heads_major_attention_bwd": lambda f: f(qkv5, key_bias, dout4, out, stats, rate, 5),
        "packed_attention_sp_fwd": lambda f: f(qkv, key_bias, H, rate, 5),
        "packed_attention_sp_bwd": lambda f: f(qkv, probs, dout, o13, H, rate, 5),
    }
    for name, call in calls.items():
        rows[name]["ms"] = cuda_time_ms(lambda: call(getattr(fa, name)), 20)
        rows[name]["plain_ms"] = cuda_time_ms(lambda: call(getattr(fa, name + "_reference")), 3)
    save_probs_passes(torch, fa, rows, qkv, key_bias, dout, o13, probs, ldp, card)
    hm_lib = sdpa_ms(torch, *qkv5.unbind(1), key_bias, dout4, rate)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(B, T, H, 3, D).unbind(3))
    sp_lib = sdpa_ms(torch, q, k, v, key_bias, dout4, rate)
    gflop = 2.0 * B * H * T * T * D / 1e9  # one [T, T] x D product over every (b, h)
    # K11/K12's bounds count what the JAX functions move, which keep no row
    # statistics (the backward recomputes them): qkv and the key bias in, out
    # out; qkv, the key bias and dout in, dqkv out. K11 writing stats and K12
    # reading them and out is the port's choice
    for name, design in (("fwd", nbytes(qkv5, key_bias, out, stats)),
                         ("bwd", nbytes(qkv5, key_bias, dout4, out, stats, qkv5))):
        log(f"heads_major_attention_{name} as designed (with out and stats): {design} bytes, "
            f"{design / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate")
    moved = {"heads_major_attention_fwd": nbytes(qkv5, key_bias, out),
             "heads_major_attention_bwd": nbytes(qkv5, key_bias, dout4, qkv5),
             "packed_attention_sp_fwd": nbytes(qkv, key_bias, o13, probs),
             "packed_attention_sp_bwd": nbytes(qkv, probs, dout, o13, qkv)}
    libs = (hm_lib[0], hm_lib[1], sp_lib[0], sp_lib[1])
    for (name, r), n_mm, lib_ms in zip(rows.items(), (2, 4, 2, 4), libs):
        # useful products: QK^T and PV forward; dV, dP, dQ, dK backward
        r.update(library_ms=lib_ms, **bound(moved[name], n_mm * gflop * 1e9, BF16_FLOPS))
        log(f"{name} B={B} T={T} H={H} dropout {rate}: kernel {r['ms']:.4f} ms "
            f"({n_mm * gflop / r['ms']:.1f} TFLOP/s useful), plain {r['plain_ms']:.4f} ms  [{card}]")
        log(row_line(name, r, card))
    del out, stats, o13, probs
    heads_major_passes(torch, fa, rows, qkv5, key_bias, dout4, card)
    heads_major_equals_packed(torch, fa, qkv5, qkv, key_bias, dout4, dout, card)
    return rows


def save_probs_passes(torch, fa, rows, qkv, key_bias, dout, o13, probs, ldp, card):
    """K13/K14 as K1/K2 are reported: each kernel's head group, blocks an
    SM, registers, local bytes and shared memory; K14's dQ and dK/dV passes
    timed apart (dropout 0.1); both kernels at dropout 0; their first
    design's times beside them."""
    from visualbert_torch.ops import _build

    B, T, _ = qkv.shape
    H, rate = 12, 0.1
    dev = qkv.device
    lib = _build.library()
    hgs = fa.sp_head_groups(lib, B, H, T, dev)
    for k, (kernel, hg) in enumerate(zip(fa.PACKED_KERNELS, hgs)):
        regs, local, smem, per_sm = (lib.vb_attn_sp_info(k, w, T) for w in range(4))
        log(f"K13/K14 {kernel}: hg {hg} ({B * H // hg} blocks of one batch row x {hg} heads), {per_sm} blocks an "
            f"SM, {regs} registers a thread, {local} bytes of local memory, {smem} bytes of shared memory at T={T}")
    args = (lib, qkv, probs, ldp, dout, o13, H, rate, 5, hgs[1], hgs[2])
    code, dqkv, delta = fa.launch_sp_bwd(*args)
    lib.check(code, "K14")
    passes = []
    for p in (1, 2):
        lib.check(fa.launch_sp_bwd(*args, passes=p, dqkv=dqkv, delta=delta)[0], f"K14 pass {p}")
        passes.append(cuda_time_ms(lambda: fa.launch_sp_bwd(*args, passes=p, dqkv=dqkv, delta=delta), 20))
    o0, p0 = fa.packed_attention_sp_fwd(qkv, key_bias, H, 0.0, 5)
    ms0 = (cuda_time_ms(lambda: fa.packed_attention_sp_fwd(qkv, key_bias, H, 0.0, 5), 20),
           cuda_time_ms(lambda: fa.packed_attention_sp_bwd(qkv, p0, dout, o0, H, 0.0, 5), 20))
    del o0, p0, dqkv, delta
    k13, k14 = rows["packed_attention_sp_fwd"], rows["packed_attention_sp_bwd"]
    log(f"K14 passes, dropout {rate}: dQ pass {passes[0]:.4f} ms, dK/dV pass {passes[1]:.4f} ms (sum "
        f"{sum(passes):.4f}, both in one call {k14['ms']:.4f} ms)  [{card}]")
    for (name, first), k, m0 in zip(SP_FIRST_DESIGN_MS.items(), (k13, k14), ms0):
        log(f"{name} B={B} T={T} H={H}: dropout {rate} {k['ms']:.4f} ms, dropout 0 {m0:.4f} ms; first design "
            f"(earlier runs, dropout {rate}) {first[0]:.4f}-{first[1]:.4f} ms: faster than its least reading: "
            f"{k['ms'] < first[0]}  [{card}]")


def heads_major_passes(torch, fa, rows, qkv5, key_bias, dout4, card):
    """K11/K12 as K1/K2 are reported: each kernel's head group, blocks an
    SM, registers, local bytes and shared memory (none of the three may
    spill); both kernels at dropout 0; their first design's times beside
    them."""
    from visualbert_torch.ops import _build

    B, _, H, T, _ = qkv5.shape
    rate = 0.1
    lib = _build.library()
    hgs = fa.hm_head_groups(lib, B, H, T, qkv5.device)
    spills = []
    for k, (kernel, hg) in enumerate(zip(fa.PACKED_KERNELS, hgs)):
        regs, local, smem, per_sm = (lib.vb_attn_hm_info(k, w, T) for w in range(4))
        log(f"K11/K12 {kernel}: hg {hg} ({B * H // hg} blocks of one batch row x {hg} heads), {per_sm} blocks an "
            f"SM, {regs} registers a thread, {local} bytes of local memory, {smem} bytes of shared memory at T={T}")
        spills += [kernel] if local else []
    if spills:
        raise SystemExit(f"K11/K12 spill to local memory in the {', '.join(spills)}")
    o0, s0 = fa.heads_major_attention_fwd(qkv5, key_bias, 0.0, 5)
    ms0 = (cuda_time_ms(lambda: fa.heads_major_attention_fwd(qkv5, key_bias, 0.0, 5), 20),
           cuda_time_ms(lambda: fa.heads_major_attention_bwd(qkv5, key_bias, dout4, o0, s0, 0.0, 5), 20))
    del o0, s0
    for (name, first), m0, most in zip(HM_FIRST_DESIGN_MS.items(), ms0, (0.40, 1.00)):
        k = rows[name]
        log(f"{name} B={B} T={T} H={H}: dropout {rate} {k['ms']:.4f} ms (at most {most:.2f}: {k['ms'] <= most}), "
            f"dropout 0 {m0:.4f} ms; first design (earlier runs, dropout {rate}) {first[0]:.4f}-{first[1]:.4f} ms: "
            f"faster than its least reading: {k['ms'] < first[0]}; library {k['library_ms']:.4f} ms, "
            f"{k['ms'] / k['library_ms']:.2f}x  [{card}]")


def heads_major_equals_packed(torch, fa, qkv5, qkv, key_bias, dout4, dout, card):
    """K11/K12 are K1/K2's kernels on the heads-major layout: on the same
    numbers (qkv the packed copy of qkv5, dout of dout4) with K1/K2's
    deferred bias zero, out, stats and dqkv must agree bit for bit, at
    dropout 0 and 0.1."""
    B, _, H, T, D = qkv5.shape
    qb = torch.zeros(3 * H * D, dtype=qkv.dtype, device=qkv.device)
    for rate in (0.0, 0.1):
        o1, s1 = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 6)
        d2, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout, o1, s1, H, rate, 6)
        o11, s11 = fa.heads_major_attention_fwd(qkv5, key_bias, rate, 6)
        d12 = fa.heads_major_attention_bwd(qkv5, key_bias, dout4, o11, s11, rate, 6)
        torch.cuda.synchronize()
        same = (torch.equal(o11.permute(0, 2, 1, 3).reshape(o1.shape), o1), torch.equal(s11, s1),
                torch.equal(d12.permute(0, 3, 2, 1, 4).reshape(d2.shape), d2))
        log(f"K11/K12 against K1/K2 on the same numbers, zero QKV bias, dropout {rate}: out, stats, dqkv bit for "
            f"bit: {same}")
        del o1, s1, d2, o11, s11, d12
        if not all(same):
            raise SystemExit(f"K11/K12 differ from K1/K2 on the same numbers at dropout {rate}")


def save_probs_at_nlvr2_shape(torch, card, B=64, T=272):
    """Whether flash_save_probs pays at NLVR2's shape (phase 9's train batch
    of 64, T = 128 + 2 x 72 = 272, 6 regions an image): K13 + K14 against
    K1 + K2 on the same numbers, dropout 0.1, CUDA events."""
    import numpy as np

    from visualbert_torch.ops import flash_attention as fa

    H, D = 12, 64
    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    qkv = torch.tensor(rng.randn(B, T, 3 * H * D), dtype=torch.bfloat16, device=dev)
    qb = torch.tensor(rng.randn(3 * H * D) * 0.1, dtype=torch.bfloat16, device=dev)
    mask = np.ones((B, T), np.float32)
    mask[::2, 100:128] = 0                      # some padded text
    mask[:, 134:200] = mask[:, 206:] = 0        # 6 regions of each image's 72
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=torch.bfloat16, device=dev)
    biased = qkv + qb  # K13 takes the biased projection, as the encoder adds it
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.1, 5)
    o13, probs = fa.packed_attention_sp_fwd(biased, key_bias, H, 0.1, 5)
    ms = [cuda_time_ms(fn, 20) for fn in (
        lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.1, 5),
        lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.1, 5),
        lambda: fa.packed_attention_sp_fwd(biased, key_bias, H, 0.1, 5),
        lambda: fa.packed_attention_sp_bwd(biased, probs, dout, o13, H, 0.1, 5))]
    log(f"flash_save_probs at NLVR2's B={B} T={T}, dropout 0.1, a layer: K13 {ms[2]:.4f} + K14 {ms[3]:.4f} = "
        f"{ms[2] + ms[3]:.4f} ms against K1 {ms[0]:.4f} + K2 {ms[1]:.4f} = {ms[0] + ms[1]:.4f} ms; the saved "
        f"probabilities hold {probs.numel() * 2 / 2**20:.1f} MiB  [{card}]")


def exp_kernel_info(T):
    """The 12 kernels of csrc/flash_attention_exp.cu (the forward, the dQ
    pass and the dK/dV pass, each in 4 instantiations) at T: registers,
    local bytes, shared memory and blocks an SM; none may spill."""
    from visualbert_torch.ops import _build
    from visualbert_torch.ops.flash_attention import PACKED_KERNELS

    lib = _build.library()
    spills = []
    for k, kernel in enumerate(PACKED_KERNELS):
        for prescale in (0, 1):
            for flag in (0, 1):
                regs, local, smem, per_sm = (lib.vb_attn_exp_info(k, w, T, prescale, flag) for w in range(4))
                label = f"{kernel}, prescale {prescale}, {'nomax' if k == 0 else 'fdrop'} {flag}"
                log(f"K15/K16 {label}: {regs} registers a thread, {local} bytes of local memory, {smem} bytes of "
                    f"shared memory, {per_sm} blocks an SM at T={T}")
                spills += [label] if local else []
    if spills:
        raise SystemExit(f"K15/K16 spill to local memory in the {'; '.join(spills)}")


def check_attention_experiments(torch, card):
    """K15 (every VARIANTS entry) and K16 (hg 6, 4, 2) against their plain
    versions on K1/K2's inputs (B=128, T=228, H=12, D=64, bf16, padded keys)
    at dropout 0 and 0.1, by K1/K2's measures: out, stats, dqkv and the bias
    gradient; each backward gets the plain forward's outputs. Kernel times of
    every variant at dropout 0.1 (the row's ms is "base" for K15 and hg=6
    for K16); plain: the plain versions at make_variant's defaults (the
    schedule knobs leave them as they are); library: scaled_dot_product_attention's
    forward and backward on the same q, k, v; bound: K1/K2's, the same
    function."""
    from visualbert_torch.ops import attention_exp as ae

    qkv, qb, key_bias, dout = packed_inputs(torch)
    B, T, F = qkv.shape
    H, D = 12, 64
    exp_kernel_info(T)
    cases = [(name, "attn_exp", ae.VARIANTS[name] or {}) for name in ae.VARIANTS]
    cases += [(f"hg={hg}", "attn_hgrid", dict(hg=hg)) for hg in (6, 4, 2)]
    rows = {f"{k}_{p}": dict(max_abs_err=0.0, variant_ms={}) for k in ("attn_exp", "attn_hgrid") for p in ("fwd", "bwd")}
    rate = 0.1  # the main path's attention dropout, for the times
    for name, kernel, kw in cases:
        fwd, bwd = getattr(ae, kernel + "_fwd"), getattr(ae, kernel + "_bwd")
        fwd_r, bwd_r = getattr(ae, kernel + "_fwd_reference"), getattr(ae, kernel + "_bwd_reference")
        for r in (0.0, 0.1):
            out, stats = fwd(qkv, qb, key_bias, H, r, 99, **kw)
            out_r, stats_r = fwd_r(qkv, qb, key_bias, H, r, 99, **kw)
            dqkv, dqb = bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, r, 99, **kw)
            dqkv_r, dqb_r = bwd_r(qkv, qb, key_bias, dout, out_r, stats_r, H, r, 99, **kw)
            torch.cuda.synchronize()
            e_out, r_out = rel_err(out, out_r)
            e_st = float((stats - stats_r).abs().max())
            e_dq, r_dq = rel_err(dqkv, dqkv_r)
            e_db, r_db = rel_err(dqb, dqb_r)
            del out, stats, out_r, stats_r, dqkv, dqkv_r
            log(f"{kernel} {name} rate {r}: out rel {r_out:.3e} (tol {EXP_OUT_TOL}), stats max_abs_err {e_st:.3e} "
                f"(tol {EXP_STATS_TOL}); dqkv rel {r_dq:.3e} (tol {EXP_DQKV_TOL}), dqkv_bias rel {r_db:.3e} "
                f"(tol {EXP_DB_TOL})")
            if not (r_out <= EXP_OUT_TOL and e_st <= EXP_STATS_TOL and r_dq <= EXP_DQKV_TOL and r_db <= EXP_DB_TOL):
                raise SystemExit(f"{kernel} {name} disagrees with its plain version at rate {r}")
            f, b = rows[kernel + "_fwd"], rows[kernel + "_bwd"]
            f["max_abs_err"] = max(f["max_abs_err"], e_out, e_st)
            b["max_abs_err"] = max(b["max_abs_err"], e_dq)
        out, stats = fwd(qkv, qb, key_bias, H, rate, 5, **kw)
        rows[kernel + "_fwd"]["variant_ms"][name] = cuda_time_ms(lambda: fwd(qkv, qb, key_bias, H, rate, 5, **kw), 10)
        rows[kernel + "_bwd"]["variant_ms"][name] = cuda_time_ms(
            lambda: bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5, **kw), 10)
        first = EXP_FIRST_DESIGN_MS[kernel + "_fwd"], EXP_FIRST_DESIGN_MS[kernel + "_bwd"]
        log(f"{kernel} {name} B={B} T={T} H={H} dropout {rate}: forward {rows[kernel + '_fwd']['variant_ms'][name]:.4f} "
            f"ms, backward {rows[kernel + '_bwd']['variant_ms'][name]:.4f} ms; first design's "
            f"{'base' if kernel == 'attn_exp' else 'hg=6'} (earlier runs) {first[0][0]:.4f}-{first[0][1]:.4f} / "
            f"{first[1][0]:.4f}-{first[1][1]:.4f} ms  [{card}]")

    q, k, v = (t.transpose(1, 2) for t in (qkv + qb).view(B, T, H, 3, D).unbind(3))
    lib = sdpa_ms(torch, q, k, v, key_bias, dout.view(B, T, H, D).transpose(1, 2), rate)
    del q, k, v
    gflop = 2.0 * B * H * T * T * D / 1e9  # one [T, T] x D product over every (b, h)
    for kernel, main in (("attn_exp", "base"), ("attn_hgrid", "hg=6")):
        kw = dict(hg=6) if kernel == "attn_hgrid" else {}
        out, stats = getattr(ae, kernel + "_fwd_reference")(qkv, qb, key_bias, H, rate, 5, **kw)
        dqkv, dqb = getattr(ae, kernel + "_bwd_reference")(qkv, qb, key_bias, dout, out, stats, H, rate, 5, **kw)
        plain = (cuda_time_ms(lambda: getattr(ae, kernel + "_fwd_reference")(qkv, qb, key_bias, H, rate, 5, **kw), 3),
                 cuda_time_ms(lambda: getattr(ae, kernel + "_bwd_reference")(qkv, qb, key_bias, dout, out, stats, H,
                                                                            rate, 5, **kw), 3))
        moved = (nbytes(qkv, qb, key_bias, out, stats), nbytes(qkv, qb, key_bias, dout, out, stats, dqkv, dqb))
        for p, n_mm, plain_ms, lib_ms, nb in zip(("fwd", "bwd"), (2, 4), plain, lib, moved):
            r = rows[f"{kernel}_{p}"]
            r.update(ms=r["variant_ms"][main], plain_ms=plain_ms, library_ms=lib_ms,
                     **bound(nb, n_mm * gflop * 1e9, BF16_FLOPS))
            log(row_line(f"{kernel}_{p} ({main})", r, card))
            least = EXP_FIRST_DESIGN_MS[f"{kernel}_{p}"][0]
            log(f"{kernel}_{p} ({main}) against its first design's least reading {least:.4f} ms: "
                f"{r['ms'] / least:.1%}, faster: {r['ms'] < least}  [{card}]")
        del out, stats, dqkv, dqb
    return rows


def run_attention_tools(torch, card):
    """The path of K15/K16: the two sweep tools' main, as a user runs them
    (python -m visualbert_torch.tools.attn_exp and ... attn_hgrid, their
    default sweeps), with every count set to 0 just before; each variant
    must launch its kernels as the tools call them and nothing else may
    launch but K1/K2, their yardstick. Returns the launches."""
    from visualbert_torch.ops import attention_exp as ae
    from visualbert_torch.tools import attn_exp, attn_hgrid

    zero_launches()
    t0 = time.perf_counter()
    exp = attn_exp.main([])
    hgrid = attn_hgrid.main([])
    wall = time.perf_counter() - t0
    launches = read_launches()
    # each sweep line: one forward and backward at dropout 0, then the timed
    # runs, each with a warm-up call: forward alone, forward + backward
    timed = 1 + attn_exp.RUNS * attn_exp.CALLS
    fwd, bwd = 1 + 2 * timed, 1 + timed
    n_exp, n_hg = len(ae.VARIANTS), len(hgrid) - 1
    want = [0] * len(KERNELS)
    want[0], want[1] = 2 * fwd, 2 * bwd  # K1/K2, one line in each tool
    want[14:18] = [n_exp * fwd, n_exp * bwd, n_hg * fwd, n_hg * bwd]
    log(f"attention tools ({len(exp) - 1} K15 variants, {n_hg} K16 hg values, {wall:.1f} s): launches "
        + launch_text(launches) + f"; want {launch_text(want)}")
    if launches != want:
        raise SystemExit(f"the attention tools launched {launches}")
    for name, r in list(exp.items()) + list(hgrid.items()):
        if name != "K1/K2" and not (math.isfinite(r["max_abs_out"]) and math.isfinite(r["max_abs_dqkv"])):
            raise SystemExit(f"the attention tools: non-finite difference for {name}")
    return launches


def run_dropout_tool(torch, card):
    """The path of K3's mask since the site kernels took its place on every
    training path: tools/dropout_steps.py's main, as a user runs it (no
    other checkout), with every count set to 0 just before. Its builds with
    a design step left out must give the kernels' bits, and its wrapper
    timings launch K3 and the site kernels through their wrappers; nothing
    else may launch. The counts are those wrapper calls: the tool's checks
    and timing rounds launch the kernels through ops/dropout.py::launch_*,
    which count nothing. Returns the launches."""
    from visualbert_torch.tools import dropout_steps

    zero_launches()
    t0 = time.perf_counter()
    dropout_steps.main([])
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"dropout_steps ({wall:.1f} s with its builds): launches " + launch_text(launches))
    k3 = [2, len(KERNELS) - 2, len(KERNELS) - 1]
    if not all(launches[i] > 0 for i in k3) or any(n for i, n in enumerate(launches) if i not in k3):
        raise SystemExit(f"tools/dropout_steps.py launched {launches}")
    return launches


def check_xent(torch, card, H=768, N=None, labels=None):
    """K4-K6 against their plain versions at the main path's rows (N = 128 x
    24 = 3072), at hidden width H (768, the main path's; 1024, bert-large's,
    is checked without a row of the kernel table), or at N rows and width
    768 (vqa_advanced's 64 x 4 = 256, a mesh rank's MESH_XENT_ROWS =
    1536: checked, timed and set beside their bounds and cuBLAS's products,
    without a row of the kernel table), or on
    a path's own ``labels`` (-1 ignored) at their N rows, likewise."""
    import numpy as np

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import B, N_PRED

    if labels is not None:
        N = len(labels)
    main_rows = N is None
    N, V = (B * N_PRED if main_rows else N), 30522
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, H), dtype=torch.bfloat16, device=dev)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.bfloat16, device=dev)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=dev)
    if labels is None:
        labels = rng.randint(0, V, N)
        labels[rng.rand(N) < 0.15] = -1
    else:
        log(f"K4-K6 on a path's labels: {int((labels < 0).sum())} of {N} rows -1 "
            f"({float((labels < 0).mean()):.1%})")
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=dev)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=dev)  # -1 computed as 0, as mlm_xent does

    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, lab)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    top = torch.topk(xe._logits(x, emb, bias), 2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > ARGMAX_MARGIN
    differ = am != am_r
    e_nll = float((nll - nll_r).abs().max())
    e_lse = float((lse - lse_r).abs().max())
    bad_clear, bad_close = int((differ & clear).sum()), int((differ & ~clear).sum())
    log(f"K4 xent fwd [{N}, {H}] x [{V}, {H}]: nll max_abs_err {e_nll:.3e}, lse max_abs_err {e_lse:.3e} "
        f"(tol {XENT_TOL}); argmax differs on {bad_clear} rows with top-2 gap > {ARGMAX_MARGIN} (must be 0) "
        f"and on {bad_close} of the {int((~clear).sum())} rows closer than that")
    if not (e_nll <= XENT_TOL and e_lse <= XENT_TOL and bad_clear == 0):
        raise SystemExit("K4 disagrees with its plain version")
    del top, clear, differ

    # the backward of both sides gets the plain lse
    dx = xe.mlm_xent_dx(x, emb, bias, lab, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, lab, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, lab, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, lab, lse_r, g)
    torch.cuda.synchronize()
    e_dx, r_dx = rel_err(dx, dx_r)
    e_de, r_de = rel_err(de, de_r)
    e_db, r_db = rel_err(db, db_r)
    log(f"K5 xent dx: max_abs_err {e_dx:.3e} (rel {r_dx:.3e}, tol {DX_TOL})")
    log(f"K6 xent dE: max_abs_err {e_de:.3e} (rel {r_de:.3e}, tol {DE_TOL}); "
        f"db max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DBIAS_TOL})")
    if not (r_dx <= DX_TOL and r_de <= DE_TOL and r_db <= DBIAS_TOL):
        raise SystemExit("K5/K6 disagree with their plain versions")
    del dx_r, de_r, db_r
    xent_design(torch, xe, x, emb, bias, lab, lse, g, card)
    if H != 768:
        for name, fn, args in (("mlm_xent_fwd", xe.mlm_xent_fwd, ()), ("mlm_xent_dx", xe.mlm_xent_dx, (lse, g)),
                               ("mlm_xent_de", xe.mlm_xent_de, (lse, g))):
            log(f"{name} [{N}, {H}] x [{V}, {H}]: kernel {cuda_time_ms(lambda: fn(x, emb, bias, lab, *args), 10):.4f} "
                f"ms  [{card}]")
        return {}

    rows = {
        "mlm_xent_fwd": dict(max_abs_err=max(e_nll, e_lse), n_mm=1,
                             ms=cuda_time_ms(lambda: xe.mlm_xent_fwd(x, emb, bias, lab), 10),
                             plain_ms=cuda_time_ms(lambda: xe.mlm_xent_fwd_reference(x, emb, bias, lab), 3)),
        "mlm_xent_dx": dict(max_abs_err=e_dx, n_mm=2,
                            ms=cuda_time_ms(lambda: xe.mlm_xent_dx(x, emb, bias, lab, lse, g), 10),
                            plain_ms=cuda_time_ms(lambda: xe.mlm_xent_dx_reference(x, emb, bias, lab, lse, g), 3)),
        "mlm_xent_de": dict(max_abs_err=max(e_de, e_db), n_mm=2,
                            ms=cuda_time_ms(lambda: xe.mlm_xent_de(x, emb, bias, lab, lse, g), 10),
                            plain_ms=cuda_time_ms(lambda: xe.mlm_xent_de_reference(x, emb, bias, lab, lse, g), 3)),
    }
    gflop = 2.0 * N * V * H / 1e9  # one N x V x H product
    moved = {"mlm_xent_fwd": nbytes(x, emb, bias, lab, nll, lse, am),
             "mlm_xent_dx": nbytes(x, emb, bias, lab, lse, g, dx),
             "mlm_xent_de": nbytes(x, emb, bias, lab, lse, g, de, db)}
    for name, r in rows.items():
        n_mm = r.pop("n_mm")
        # no single PyTorch call computes a fused cross-entropy's pieces
        r.update(library_ms=None, **bound(moved[name], n_mm * gflop * 1e9, BF16_FLOPS))
        log(f"{name} [{N}, {H}] x [{V}, {H}]: kernel {r['ms']:.4f} ms ({n_mm * gflop / r['ms']:.1f} "
            f"TFLOP/s in its products), plain {r['plain_ms']:.4f} ms  [{card}]")
        log(row_line(name, r, card))
    for name, first in XENT_FIRST_DESIGN_MS.items() if main_rows else ():
        log(f"{name} [{N}, {H}] x [{V}, {H}]: {rows[name]['ms']:.4f} ms; first design (earlier runs) "
            f"{first[0]:.4f}-{first[1]:.4f} ms: faster than its least reading: {rows[name]['ms'] < first[0]}  [{card}]")
    # yardstick, not the fused function and not library_ms: the same two
    # bf16 products of each kernel through torch.matmul (cuBLAS), with a
    # materialised [N, V] bf16 dlog
    p = torch.empty((N, V), dtype=torch.bfloat16, device=dev).normal_()
    ms_fwd = cuda_time_ms(lambda: torch.matmul(x, emb.t()), 10)
    ms_dx = cuda_time_ms(lambda: (torch.matmul(x, emb.t()), torch.matmul(p, emb)), 10)
    ms_de = cuda_time_ms(lambda: (torch.matmul(x, emb.t()), torch.matmul(p.t(), x)), 10)
    del p
    # a bf16 row of V = 30522 logits is 61,044 B, not a multiple of 16 B:
    # the same product at V padded to the next multiple of 8 (zero rows)
    V_pad = -(-V // 8) * 8
    emb_pad = torch.zeros((V_pad, H), dtype=emb.dtype, device=dev)
    emb_pad[:V] = emb
    ms_pad = cuda_time_ms(lambda: torch.matmul(x, emb_pad.t()), 10)
    del emb_pad
    k4_ms = rows["mlm_xent_fwd"]["ms"]
    log(f"mlm_xent_fwd's product [{N}, {H}] x [{V}, {H}] as a cuBLAS product (x E^T; not the fused function): "
        f"{ms_fwd:.4f} ms "
        f"({gflop / ms_fwd:.1f} TFLOP/s), at V padded to {V_pad} {ms_pad:.4f} ms "
        f"({gflop * V_pad / V / ms_pad:.1f} TFLOP/s); the kernel {k4_ms:.4f} ms, {k4_ms / ms_fwd:.2f}x and "
        f"{k4_ms / ms_pad:.2f}x  [{card}]")
    for name, ms in (("mlm_xent_dx", ms_dx), ("mlm_xent_de", ms_de)):
        log(f"{name}'s two products at N = {N} as cuBLAS products (x E^T, then dlog E or dlog^T x; not the fused "
            f"function): "
            f"{ms:.4f} ms ({2 * gflop / ms:.1f} TFLOP/s); the kernel {rows[name]['ms']:.4f} ms  [{card}]")
    # a wrapper's host time a call at or above its kernel's time makes the
    # events above time the host
    log(f"K4 wrapper's host time a call at N = {N} (enqueue only): "
        f"{host_us_a_call(torch, lambda: xe.mlm_xent_fwd(x, emb, bias, lab), 50):.1f} us against "
        f"{rows['mlm_xent_fwd']['ms'] * 1e3:.1f} us timed  [{card}]")
    return rows


def xent_design(torch, xe, x, emb, bias, lab, lse, g, card):
    """K4's and K5/K6's design facts at these shapes: registers, local bytes,
    shared bytes and blocks an SM of each kernel (none may spill), the grid,
    K4's and K5's vocabulary splits, and the TFLOP/s of each kernel's
    products."""
    from visualbert_torch.ops import _build

    lib = _build.library()
    (N, H), V = x.shape, emb.shape[0]
    sms = xe.sm_count(x.device)
    rows, tile, cols = (lib.vb_xent_geometry(w, H) for w in (2, 4, 5))
    fwd_rows, fwd_tile = lib.vb_xent_geometry(1, H), lib.vb_xent_geometry(3, H)
    fwd_plan = xe.fwd_plan(N, V, H, fwd_rows, fwd_tile, sms)
    if H == xe.H1024:  # the 1024 form's cluster: the plans its wrappers take
        dx_plan = xe.wide_dx_plan(N, V, H, rows, tile, cols, xe.h1024_clusters(lib, 0, x.dtype))
        de_plan = xe.wide_de_plan(V, H, rows, cols)
    else:
        dx_plan = xe.dx_plan(N, V, H, rows, tile, cols, sms)
        de_plan = xe.de_plan(V, H, rows, cols)
    gflop = 2.0 * N * V * H / 1e9
    for k, number, name, fn, args, n_mm, grid in (
            (2, 4, "mlm_xent_fwd", xe.mlm_xent_fwd, (), 1, f"grid {fwd_plan['grid']} (blocks of {fwd_rows} rows, "
             f"splits of {fwd_plan['per']} tiles of {fwd_tile} vocabulary rows)"),
            (0, 5, "mlm_xent_dx", xe.mlm_xent_dx, (lse, g), 2, f"grid {dx_plan['grid']} (row blocks, column parts, "
             f"splits of {dx_plan['per']} tiles of {tile} vocabulary rows), {cols} columns a block"),
            (1, 6, "mlm_xent_de", xe.mlm_xent_de, (lse, g), 2, f"grid {de_plan['grid']} (vocabulary blocks, column "
             f"parts; x in tiles of {tile} rows), {cols} columns a block")):
        regs, local, smem, per_sm = (lib.vb_xent_info(k, w, H) for w in range(4))
        ms = cuda_time_ms(lambda: fn(x, emb, bias, lab, *args), 10)
        log(f"K{number} {name} at width {H}: {regs} registers a thread, {local} bytes of local memory, {smem} bytes "
            f"of shared memory, {per_sm} blocks an SM, {grid}; {ms:.4f} ms, "
            f"{n_mm * gflop / ms:.1f} TFLOP/s in its products  [{card}]")
        if local:
            raise SystemExit(f"K{number} spills to local memory at width {H}")


def card_device(torch):
    """The device the phases that hold the kernels' other forms run on."""
    return torch.device("cuda")


def form_tols(dtype):
    """(out, stats, dqkv, bias gradient) limits of a K1/K2 form in
    ``dtype``: fp32's own, bf16's for bf16 and fp16."""
    if dtype == "float32":
        return F32_REL_TOL, F32_ABS_TOL, F32_REL_TOL, F32_REL_TOL
    return OUT_TOL, STATS_TOL, DQKV_TOL, DB_TOL


def attention_inputs_at(torch, dtype, D, H=12, B=None, T=None):
    """K1/K2's inputs at the main path's B, T and key bias
    (tools/main_path.py::packed_attention_inputs), or at the B and T given
    (the text's padding then ends at T / 2), in ``dtype`` at head dim D:
    qkv [B, T, H*3*D], qb, key_bias, dout, from RandomState(0)."""
    import numpy as np

    from visualbert_torch.tools import main_path

    if T is None:
        B, TT, T = main_path.B, main_path.TT, main_path.TT + main_path.TV
    else:
        TT = T // 2
    F = 3 * H * D
    dev, dt = card_device(torch), getattr(torch, dtype)
    rng = np.random.RandomState(0)
    qkv = torch.tensor(rng.randn(B, T, F), dtype=dt, device=dev)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=dt, device=dev)
    mask = np.ones((B, T), np.float32)
    mask[::3, TT - 20:TT] = 0
    mask[1::4, T - 30:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=dt, device=dev)
    return qkv, qb, key_bias, dout


def sdpa_ms_in(torch, qkv, qb, key_bias, dout, H, rate):
    """scaled_dot_product_attention's forward and backward times on the same
    biased q, k, v in their own dtype, the key bias as its mask."""
    B, T, F = qkv.shape
    D = F // (3 * H)
    q, k, v = (qkv + qb).view(B, T, H, 3, D).unbind(3)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_mask = key_bias.to(qkv.dtype)[:, None, None, :]
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=attn_mask, dropout_p=rate), 20)
    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*leaves, attn_mask=attn_mask, dropout_p=rate)
    g = dout.view(B, T, H, D).transpose(1, 2)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), 20)
    return fwd, bwd


def earlier_design_line(key, ms, card):
    """A redesigned form's time beside EARLIER_DESIGN_MS's reading of it."""
    if key in EARLIER_DESIGN_MS:
        was = EARLIER_DESIGN_MS[key]
        dim = "H" if key[0].startswith("mlm_xent") else "D"
        log(f"{key[0]} {key[1]} {dim}={key[2]}: {ms:.4f} ms, the earlier design's {was:.4f} ms: {was / ms:.2f}x  "
            f"[{card}]")


def check_attention_forms(torch, card, main_k2_ms):
    """K1/K2 in the forms of ATTENTION_FORMS at the main path's B, T and 12
    heads, dropout 0 and 0.1, against their plain versions (fp32 at
    F32_REL_TOL / F32_ABS_TOL, the rest at bf16's limits), two calls giving
    the same bits; each timed at dropout 0.1 beside its plain version,
    scaled_dot_product_attention in the same dtype and its bound (the
    unpadded head dim's bytes and products), with each kernel's registers,
    local bytes, shared bytes and blocks an SM (bf16/fp16: K1's and K2's
    forms apart, each with its heads a block and T limit); the fp32 kernels
    and K2's forms at 16 and 32 may not spill; K2 at 16 and 32 printed
    beside SDPA and the D = 64 K2 of this call (bf16: the main path's,
    ``main_k2_ms``). Returns the fp32 kernels' table rows at D = 64 and
    {(wrapper, dtype, D): row} of every form."""
    from visualbert_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions in fp32 (PyTorch's default)
    H, rows, form_rows = 12, {}, {}
    for dtype, D in ATTENTION_FORMS:
        qkv, qb, key_bias, dout = attention_inputs_at(torch, dtype, D, H)
        B, T, F = qkv.shape
        form = fa.attention_form(qkv.dtype, D)
        t_out, t_st, t_dq, t_db = form_tols(dtype)
        where = f"{dtype} D={D} [{B}, {T}, {F}] (forms {form}, K2 {fa.bwd_attention_form(qkv.dtype, D)})"
        k1, k2 = dict(max_abs_err=0.0), dict(max_abs_err=0.0)
        for rate in (0.0, 0.1):
            out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
            out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
            dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
            dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
            torch.cuda.synchronize()
            e_out, r_out = rel_err(out, out_r)
            e_st = float((stats - stats_r).abs().max())
            e_dq, r_dq = rel_err(dqkv, dqkv_r)
            e_db, r_db = rel_err(dqb, dqb_r)
            log(f"K1 {where} rate {rate}: out max_abs_err {e_out:.3e} (rel {r_out:.3e}, tol {t_out}); stats "
                f"max_abs_err {e_st:.3e} (tol {t_st}); K2: dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, tol {t_dq}); "
                f"dqkv_bias max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {t_db})")
            if not (r_out <= t_out and e_st <= t_st and r_dq <= t_dq and r_db <= t_db):
                raise SystemExit(f"K1/K2 {where} disagree with their plain versions at rate {rate}")
            k1["max_abs_err"] = max(k1["max_abs_err"], e_out)
            k2["max_abs_err"] = max(k2["max_abs_err"], e_dq)
        del out_r, dqkv_r, dqkv
        rate = 0.1
        runs = []
        for _ in range(2):
            o1, s1 = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5)
            runs.append((o1, s1) + fa.packed_attention_bwd(qkv, qb, key_bias, dout, o1, s1, H, rate, 5))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"K1/K2 {where} rate {rate}: two calls give the same bits: {same}")
        if not same:
            raise SystemExit(f"K1/K2 {where}: two calls differ")
        del runs, o1, s1
        k1["ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 10)
        k1["plain_ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5), 3)
        k2["ms"] = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 10)
        k2["plain_ms"] = cuda_time_ms(
            lambda: fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 3)
        k1["library_ms"], k2["library_ms"] = sdpa_ms_in(torch, qkv, qb, key_bias, dout, H, rate)
        gflop = 2.0 * B * H * T * T * D / 1e9
        peak = FP32_FLOPS if dtype == "float32" else BF16_FLOPS
        k1.update(bound(nbytes(qkv, qb, key_bias, out, stats), 2 * gflop * 1e9, peak))
        # K2 writes dqkv and dqb: qkv's and qb's sizes
        k2.update(bound(nbytes(qkv, qb, key_bias, dout, out, stats, qkv, qb), 4 * gflop * 1e9, peak))
        from visualbert_torch.ops import _build

        lib = _build.library()
        if dtype != "float32":
            code = 0 if dtype == "bfloat16" else 1
            for pair, dp, ks in (("K1", fa.kernel_head_dim(D), (0,)), ("K2", fa.bwd_head_dim(D), (1, 2))):
                hgs = fa.packed_x_head_groups(lib, qkv.dtype, dp, B, H, T, qkv.device)
                streamed = pair == "K2" and dp == fa.STREAMED_HEAD_DIM
                # K1's check holds all three kernels' bytes (its forward bounds the path), K2's its passes'
                smem = ((lambda t: lib.vb_attn_packed_x_smem_bytes(dp, t)) if pair == "K1" else
                        (lambda t: max(lib.vb_attn_packed_x_info(code, dp, k, 2, t) for k in ks)))
                limit = max(t for t in range(64, 8192, 64) if smem(t) <= fa.MAX_SMEM_BYTES)
                for k in ks:
                    regs, local, nsmem, per_sm = (lib.vb_attn_packed_x_info(code, dp, k, w, T) for w in range(4))
                    grid = ("a block a (128 rows, head, batch row), two warpgroups" if streamed else f"hg {hgs[k]}")
                    log(f"{pair} {dtype} at head dim {dp} {fa.PACKED_KERNELS[k]}: {grid}, {per_sm} blocks an "
                        f"SM, {regs} registers a thread, {local} bytes of local memory, {nsmem} bytes of shared "
                        f"memory at T={T}; T up to {limit}" + (" (the same bytes at every T)" if streamed else ""))
                    if (dp < fa.KERNEL_HEAD_DIM or streamed) and local != 0:
                        raise SystemExit(f"K2 {dtype} at head dim {dp}: the {fa.PACKED_KERNELS[k]} spills {local} "
                                         f"bytes")
                if dp != D:
                    pad_ms = cuda_time_ms(lambda: fa.pad_heads(qkv, H, 3, dp), 10)
                    log(f"{pair} {where}: the wrapper's zero-padding of qkv to D={dp} alone {pad_ms:.4f} ms  [{card}]")
        else:
            for k, kernel in enumerate(fa.PACKED_KERNELS):
                regs, local, smem, per_sm = (lib.vb_attn_f32_info(k, w, D) for w in range(4))
                log(f"K1/K2 fp32 at D={D} {kernel}: {per_sm} blocks an SM, {regs} registers a thread, {local} bytes "
                    f"of local memory, {smem} bytes of shared memory")
                if local != 0:
                    raise SystemExit(f"K1/K2 fp32 at D={D}: the {kernel} spills {local} bytes")
        for name, r in (("packed_attention_fwd", k1), ("packed_attention_bwd", k2)):
            log(row_line(f"{name} {where}", r, card))
            earlier_design_line((name, dtype, D), r["ms"], card)
            form_rows[(name, dtype, D)] = r
        if dtype == "float32" and D == 64:
            rows["packed_attention_fwd (fp32)"], rows["packed_attention_bwd (fp32)"] = k1, k2
        del qkv, qb, key_bias, dout, out, stats
        torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float16"):
        check_streamed_long_t(torch, card, dtype)
        r = form_rows[("packed_attention_bwd", dtype, 128)]
        was = EARLIER_DESIGN_MS[("packed_attention_bwd", dtype, 128)]
        log(f"K2 {dtype} D=128 on its streamed passes: {r['ms']:.4f} ms (SDPA {r['library_ms']:.4f}, "
            f"{r['ms'] / r['library_ms']:.2f}x; the passes that held a head's rows {was:.4f} ms, "
            f"{was / r['ms']:.2f}x)  [{card}]")
    for dtype in ("bfloat16", "float16"):
        k2 = {D: form_rows[("packed_attention_bwd", dtype, D)] for D in (16, 32)}
        d64 = main_k2_ms if dtype == "bfloat16" else form_rows[("packed_attention_bwd", dtype, 64)]["ms"]
        log(f"K2 {dtype}: D=16 {k2[16]['ms']:.4f} ms (SDPA {k2[16]['library_ms']:.4f}, "
            f"{k2[16]['ms'] / k2[16]['library_ms']:.2f}x), D=32 {k2[32]['ms']:.4f} ms (SDPA "
            f"{k2[32]['library_ms']:.4f}, {k2[32]['ms'] / k2[32]['library_ms']:.2f}x), D=64 {d64:.4f} ms in this "
            f"call: D=32 {'faster' if k2[32]['ms'] < d64 else 'not faster'} than D=64  [{card}]")
    return rows, form_rows


def check_streamed_long_t(torch, card, dtype):
    """K2 at D = 128 in ``dtype`` at T = STREAMED_LONG_T (B = 8, 12 heads),
    past K1's limit and the 256 its passes took while they held a head's
    rows, on the plain forward's outputs: dqkv and the bias gradient within
    bf16's limits at dropout 0 and 0.1, two calls giving the same bits,
    timed beside scaled_dot_product_attention's backward."""
    from visualbert_torch.ops import flash_attention as fa

    H, B, T = 12, 8, STREAMED_LONG_T
    qkv, qb, key_bias, dout = attention_inputs_at(torch, dtype, 128, H, B, T)
    where = f"K2 {dtype} D=128 [{B}, {T}, {qkv.shape[-1]}] ({fa.bwd_attention_form(qkv.dtype, 128)})"
    for rate in (0.0, 0.1):
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
        runs = [fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99) for _ in range(2)]
        dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
        torch.cuda.synchronize()
        (dqkv, dqb), again = runs
        e_dq, r_dq = rel_err(dqkv, dqkv_r)
        e_db, r_db = rel_err(dqb, dqb_r)
        same = all(torch.equal(a, b) for a, b in zip(runs[0], again))
        log(f"{where} rate {rate}: dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, tol {DQKV_TOL}); dqkv_bias "
            f"max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DB_TOL}); two calls give the same bits: {same}")
        if not (r_dq <= DQKV_TOL and r_db <= DB_TOL and same):
            raise SystemExit(f"{where} disagrees with its plain version at rate {rate}, or two calls differ")
        del runs, dqkv, dqb, again, dqkv_r, dqb_r
    ms = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, 0.1, 5), 10)
    _, sdpa = sdpa_ms_in(torch, qkv, qb, key_bias, dout, H, 0.1)
    log(f"{where} rate 0.1: {ms:.4f} ms, SDPA's backward {sdpa:.4f} ms ({ms / sdpa:.2f}x)  [{card}]")
    del qkv, qb, key_bias, dout, out_r, stats_r
    torch.cuda.empty_cache()


def xent_inputs_at(torch, dtype, H, N, V=30522):
    """K4-K6's inputs as check_xent makes them (RandomState(1), 15 % of
    labels -1 and computed as 0, a non-uniform cotangent) in ``dtype`` at
    width H: x, emb, bias, lab, g."""
    import numpy as np

    dev, dt = card_device(torch), getattr(torch, dtype)
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, H), dtype=dt, device=dev)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=dt, device=dev)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=dev)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=dev)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=dev)
    return x, emb, bias, lab, g


def check_xent_forms(torch, card):
    """K4-K6 in the forms of XENT_FORMS at the main path's N = 3072 rows and
    V = 30522, against their plain versions (fp32 at F32_ABS_TOL /
    F32_REL_TOL, the rest at bf16's limits; argmax as check_xent holds it);
    fp32, wide and 1024 (bf16 and fp16) K4-K6 called again on the same
    inputs must give the same bits (the wide and the 1024 K5/K6 with the
    cluster each of their blocks
    is in, the clusters the card runs at once, and the TFLOP/s of their two
    useful products printed; their db held at DBIAS_TOL to the exact
    products' (tools/xent_steps.py::db_exact: the plain version's own fp32
    sums drift beyond DBIAS_TOL at 2560), its distance to the plain version
    and the plain version's own distance to the exact products printed);
    each timed beside its plain version, cuBLAS's products of the same
    dtype (x E^T; with dlog E or dlog^T x) and its bound, with the N x V x H
    products its design runs, its registers, local bytes (none may spill),
    shared bytes and blocks an SM; a padded width also with the [V, H_pad]
    copy of E it makes. Returns the fp32 kernels' table rows at H = 768 and
    {(wrapper, dtype, width): row} of every form."""
    from visualbert_torch.ops import _build
    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import B, N_PRED
    from visualbert_torch.tools.xent_steps import db_exact

    torch.backends.cuda.matmul.allow_tf32 = False
    lib, N, V, rows, form_rows = _build.library(), B * N_PRED, 30522, {}, {}
    for dtype, H in XENT_FORMS:
        x, emb, bias, lab, g = xent_inputs_at(torch, dtype, H, N, V)
        form = xe.xent_form(x.dtype, H)
        wide = xe.is_wide(H) and not xe.runs_on_f32(x.dtype, H)
        # K5/K6 in thread-block clusters: the wide form and the 1024 form
        clustered = wide or (not xe.runs_on_f32(x.dtype, H) and xe.kernel_width(H) == xe.H1024)
        if dtype == "float32":
            t_lse, t_dx, t_de, t_db = F32_ABS_TOL, F32_REL_TOL, F32_REL_TOL, F32_REL_TOL
        else:
            t_lse, t_dx, t_de, t_db = XENT_TOL, DX_TOL, DE_TOL, DBIAS_TOL
        where = f"{dtype} H={H} [{N}, {H}] x [{V}, {H}] (form {form})"
        nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, lab)
        nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
        top = torch.topk(xe._logits(x, emb, bias), 2, dim=-1).values
        bad_clear = int(((am != am_r) & ((top[:, 0] - top[:, 1]) > ARGMAX_MARGIN)).sum())
        del top
        e_nll, e_lse = float((nll - nll_r).abs().max()), float((lse - lse_r).abs().max())
        dx = xe.mlm_xent_dx(x, emb, bias, lab, lse_r, g)
        dx_r = xe.mlm_xent_dx_reference(x, emb, bias, lab, lse_r, g)
        de, db = xe.mlm_xent_de(x, emb, bias, lab, lse_r, g)
        de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, lab, lse_r, g)
        torch.cuda.synchronize()
        e_dx, r_dx = rel_err(dx, dx_r)
        e_de, r_de = rel_err(de, de_r)
        e_db, r_db = rel_err(db, db_r)
        if wide:  # db against the exact products' (tools/xent_steps.py::db_exact)
            db64 = db_exact(x, emb, bias, lab, lse_r, g)
            r_plain = rel_err(db_r, db64)[1]
            e_db, r_db_plain, r_db = *rel_err(db, db_r), rel_err(db, db64)[1]
            log(f"K6 {where}: db against fp64 products on the same lse {r_db:.3e} (tol {t_db}); the plain "
                f"version's {r_plain:.3e}; the kernel against the plain version {r_db_plain:.3e}  [{card}]")
            del db64
        del dx_r, de_r, db_r
        log(f"K4 {where}: nll max_abs_err {e_nll:.3e}, lse max_abs_err {e_lse:.3e} (tol {t_lse}); argmax differs on "
            f"{bad_clear} rows with top-2 gap > {ARGMAX_MARGIN} (must be 0); K5 dx max_abs_err {e_dx:.3e} (rel "
            f"{r_dx:.3e}, tol {t_dx}); K6 dE max_abs_err {e_de:.3e} (rel {r_de:.3e}, tol {t_de}), db max_abs_err "
            f"{e_db:.3e} (rel {r_db:.3e}, tol {t_db})")
        if not (e_nll <= t_lse and e_lse <= t_lse and bad_clear == 0 and r_dx <= t_dx and r_de <= t_de
                and r_db <= t_db):
            raise SystemExit(f"K4-K6 {where} disagree with their plain versions")
        if dtype == "float32" or clustered:
            again = (*xe.mlm_xent_fwd(x, emb, bias, lab), xe.mlm_xent_dx(x, emb, bias, lab, lse_r, g),
                     *xe.mlm_xent_de(x, emb, bias, lab, lse_r, g))
            same = [torch.equal(a, b) for a, b in zip((nll, lse, am, dx, de, db), again)]
            log(f"K4-K6 {where}: a second call's nll, lse, argmax, dx, dE, db bit for bit: {same}")
            if not all(same):
                raise SystemExit(f"K4-K6 {where} differ between two calls on the same inputs")
            del again
        fns = {"mlm_xent_fwd": (xe.mlm_xent_fwd, xe.mlm_xent_fwd_reference, (), max(e_nll, e_lse), 1),
               "mlm_xent_dx": (xe.mlm_xent_dx, xe.mlm_xent_dx_reference, (lse, g), e_dx, 2),
               "mlm_xent_de": (xe.mlm_xent_de, xe.mlm_xent_de_reference, (lse, g), max(e_de, e_db), 2)}
        moved = {"mlm_xent_fwd": nbytes(x, emb, bias, lab, nll, lse, am), "mlm_xent_dx": nbytes(x, emb, bias, lab, lse, g, dx),
                 "mlm_xent_de": nbytes(x, emb, bias, lab, lse, g, de, db)}
        gflop = 2.0 * N * V * H / 1e9
        peak = FP32_FLOPS if dtype == "float32" else BF16_FLOPS
        p = torch.empty((N, V), dtype=x.dtype, device=x.device).normal_()
        products = {"mlm_xent_fwd": lambda: torch.matmul(x, emb.t()),
                    "mlm_xent_dx": lambda: (torch.matmul(x, emb.t()), torch.matmul(p, emb)),
                    "mlm_xent_de": lambda: (torch.matmul(x, emb.t()), torch.matmul(p.t(), x))}
        design = {"mlm_xent_fwd": 1, "mlm_xent_dx": xe.bwd_products(x.dtype, H),
                  "mlm_xent_de": xe.bwd_products(x.dtype, H)}
        for name, (fn, ref, extra, err, n_mm) in fns.items():
            r = dict(max_abs_err=err, ms=cuda_time_ms(lambda: fn(x, emb, bias, lab, *extra), 5),
                     plain_ms=cuda_time_ms(lambda: ref(x, emb, bias, lab, *extra), 2), library_ms=None,
                     **bound(moved[name], n_mm * gflop * 1e9, peak))
            cublas = cuda_time_ms(products[name], 5)
            log(row_line(f"{name} {where}", r, card)
                + f"; cuBLAS's {n_mm} product(s) in {dtype} (not the fused function) {cublas:.4f} ms, the kernel "
                  f"{r['ms'] / cublas:.2f}x; the design runs {design[name]} N x V x H product(s), "
                  f"{design[name] * gflop / r['ms']:.1f} TFLOP/s; {n_mm * gflop / r['ms']:.1f} TFLOP/s on the "
                  f"{n_mm} useful")
            earlier_design_line((name, dtype, H), r["ms"], card)
            if dtype == "float32" and H == 768:
                rows[f"{name} (fp32)"] = r
            form_rows[(name, dtype, H)] = r
        del p
        on_f32 = xe.runs_on_f32(x.dtype, H)
        hk = H if on_f32 else xe.kernel_width(H)
        if on_f32:
            info = lib.vb_xent_f32_info
        elif xe.is_wide(H):
            info = {"bfloat16": lib.vb_xent_wide_info, "float16": lib.vb_xent_f16_wide_info}[dtype]
        else:
            info = {"bfloat16": lib.vb_xent_info, "float16": lib.vb_xent_f16_info}[dtype]
        for k, kernel in enumerate(("K5", "K6", "K4")):
            regs, local, smem, per_sm = (info(k, w, hk) for w in range(4))
            cluster = ""
            if clustered and k < 2:
                R, panels = xe.wide_cluster(hk, (lib.vb_xent_wide_geometry(5) if wide
                                                 else lib.vb_xent_geometry(5, hk)))
                cluster = (f", clusters of {R} blocks ({panels} panels of 64 columns a block), "
                           f"{info(k, 4, hk)} clusters at once")
            log(f"{kernel} {dtype} at width {hk} (form {form}): {regs} registers a thread, {local} bytes of local "
                f"memory, {smem} bytes of shared memory, {per_sm} blocks an SM{cluster}  [{card}]")
            if local != 0:
                raise SystemExit(f"{kernel} {dtype} at width {hk} spills ({local} bytes of local memory)")
        if not on_f32 and hk != H:
            copy_ms = cuda_time_ms(lambda: xe.pad_width(emb, hk), 10)
            log(f"K4-K6 {where}: each call's [{V}, {hk}] zero-padded copy of E alone {copy_ms:.4f} ms  [{card}]")
        del x, emb, bias, lab, g, nll, lse, am, dx, de, db
        torch.cuda.empty_cache()
    return rows, form_rows


def variant_inputs_at(torch, variant, dtype, D, H=12):
    """K11/K12's ("heads_major": the biased q, k, v [B, 3, H, T, D], dout
    [B, H, T, D]) or K13/K14's ("save_probs": the biased packed qkv, dout
    [B, T, H*D]) inputs from attention_inputs_at's numbers, with its key
    bias, and its packed qkv, qkv bias and dout (for the library's SDPA)."""
    qkv, qb, key_bias, dout = attention_inputs_at(torch, dtype, D, H)
    B, T, _ = qkv.shape
    x = qkv + qb
    if variant == "heads_major":
        x = x.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        dout_v = dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous()
    else:
        x, dout_v = x.contiguous(), dout
    return x, key_bias, dout_v, qkv, qb, dout


def variant_fwd_head_dim(fa, variant, D):
    """The head dim a K11 (kernel_head_dim) or K13 (bwd_head_dim, its own
    small-row forms below 64) form's forward runs D at."""
    return fa.kernel_head_dim(D) if variant == "heads_major" else fa.bwd_head_dim(D)


def variant_info(lib, fa, variant, dtype, D, T):
    """[registers, local bytes, shared bytes, blocks an SM] of the forward,
    dQ pass and dK/dV pass of a K11-K14 form: the forward at
    variant_fwd_head_dim, the backward's passes at bwd_head_dim(D)."""
    if dtype == "float32":
        info = lib.vb_attn_f32_info if variant == "heads_major" else lib.vb_attn_f32_sp_info
        return [[info(k, w, D) for w in range(4)] for k in range(3)]
    info = lib.vb_attn_hm_x_info if variant == "heads_major" else lib.vb_attn_sp_x_info
    dps = (variant_fwd_head_dim(fa, variant, D), fa.bwd_head_dim(D), fa.bwd_head_dim(D))
    return [[info(0 if dtype == "bfloat16" else 1, dp, k, w, T) for w in range(4)] for k, dp in enumerate(dps)]


def variant_geometry(lib, fa, variant, x, D):
    """{kernel: (instantiated head dim, hg, T limit)} of a bf16 or fp16
    K11-K14 form on x: the forward at variant_fwd_head_dim, the backward's
    two passes at bwd_head_dim(D) (their own shared memory and occupancy)."""
    B, T = (x.shape[0], x.shape[3]) if variant == "heads_major" else x.shape[:2]
    H = x.shape[2] if variant == "heads_major" else x.shape[2] // (3 * D)
    pre = "hm" if variant == "heads_major" else "sp"
    groups = fa.hm_x_head_groups if variant == "heads_major" else fa.sp_x_head_groups
    smem = getattr(lib, f"vb_attn_{pre}_x_smem_bytes")
    out = {}
    for k, dp in enumerate((variant_fwd_head_dim(fa, variant, D), fa.bwd_head_dim(D), fa.bwd_head_dim(D))):
        hg = groups(lib, x.dtype, dp, B, H, T, x.device)[k]
        out[fa.PACKED_KERNELS[k]] = (dp, hg, max(t for t in range(64, 8192, 64) if smem(dp, t) <= fa.MAX_SMEM_BYTES))
    return out


def check_variant_forms(torch, card):
    """K11/K12 and K13/K14 in the forms of ATTENTION_FORMS at the main
    path's B, T and 12 heads, dropout 0 and 0.1, against their plain
    versions (fp32 at F32_REL_TOL / F32_ABS_TOL, the rest at K11-K14's bf16
    limits; K13's bf16 probabilities within PROBS_ULPS of their plain
    values in every dtype, and K14 fed K13's own probabilities and output
    within SP_CHAIN_TOL); each timed at dropout 0.1 beside its plain
    version, scaled_dot_product_attention in the same dtype and its bound
    (the unpadded head dim's bytes, as the JAX functions move them, and
    products), printed with each kernel's registers, local bytes, shared
    bytes and blocks an SM (bf16, fp16: also its instantiated head dim,
    heads a block and T limit; K12's, K13's and K14's small forms at D <= 32
    may not spill), and K12 / K13 / K14 at D = 16 and 32 beside SDPA and
    their padded route's reading (EARLIER_DESIGN_MS). Returns {(wrapper
    name, dtype, D): table row}."""
    from visualbert_torch.ops import _build
    from visualbert_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    lib, H, rows = _build.library(), 12, {}
    for variant, fwd, bwd in (("heads_major", "heads_major_attention_fwd", "heads_major_attention_bwd"),
                              ("save_probs", "packed_attention_sp_fwd", "packed_attention_sp_bwd")):
        k_fwd, k_bwd = ("K11", "K12") if variant == "heads_major" else ("K13", "K14")
        for dtype, D in ATTENTION_FORMS:
            x, key_bias, dout, qkv, qb, dout_p = variant_inputs_at(torch, variant, dtype, D, H)
            B, T = key_bias.shape
            f32 = dtype == "float32"
            if variant == "heads_major":
                t_out, t_bwd = (F32_REL_TOL, F32_REL_TOL) if f32 else (HM_OUT_TOL, HM_DQKV_TOL)
            else:
                t_out, t_bwd = (F32_REL_TOL, F32_REL_TOL) if f32 else (SP_OUT_TOL, SP_DQKV_TOL)
            t_st = F32_ABS_TOL if f32 else STATS_TOL
            fwd_form = fa.attention_form if variant == "heads_major" else fa.sp_attention_form
            where = (f"{dtype} D={D} B={B} T={T} H={H} (forms {fwd_form(x.dtype, D)}, "
                     f"{k_bwd} {fa.bwd_attention_form(x.dtype, D)})")
            r_f, r_b = dict(max_abs_err=0.0), dict(max_abs_err=0.0)
            for rate in (0.0, 0.1):
                r_own = 0.0
                if variant == "heads_major":
                    out, second = fa.heads_major_attention_fwd(x, key_bias, rate, 99)
                    out_r, second_r = fa.heads_major_attention_fwd_reference(x, key_bias, rate, 99)
                    dq = fa.heads_major_attention_bwd(x, key_bias, dout, out_r, second_r, rate, 99)
                    dq_r = fa.heads_major_attention_bwd_reference(x, key_bias, dout, out_r, second_r, rate, 99)
                else:
                    out, second = fa.packed_attention_sp_fwd(x, key_bias, H, rate, 99)
                    out_r, second_r = fa.packed_attention_sp_fwd_reference(x, key_bias, H, rate, 99)
                    dq = fa.packed_attention_sp_bwd(x, second_r, dout, out_r, H, rate, 99)
                    dq_r = fa.packed_attention_sp_bwd_reference(x, second_r, dout, out_r, H, rate, 99)
                    r_own = rel_err(fa.packed_attention_sp_bwd(x, second, dout, out, H, rate, 99), dq_r)[1]
                torch.cuda.synchronize()
                e_out, r_out = rel_err(out, out_r)
                if variant == "heads_major":
                    e_2 = float((second - second_r).abs().max())
                    ok2, what2 = e_2 <= t_st, f"stats max_abs_err {e_2:.3e} (tol {t_st})"
                else:
                    dp = (second.float() - second_r.float()).abs()
                    e_2, u_2 = float(dp.max()), float((dp / bf16_ulps(torch, second_r)).max())
                    ok2 = u_2 <= PROBS_ULPS
                    what2 = f"bf16 probs max_abs_err {e_2:.3e}, at most {u_2:g} bf16 ulps (tol {PROBS_ULPS})"
                    del dp
                e_dq, r_dq = rel_err(dq, dq_r)
                log(f"{k_fwd}/{k_bwd} {where} rate {rate}: out max_abs_err {e_out:.3e} (rel {r_out:.3e}, tol "
                    f"{t_out}); {what2}; dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, tol {t_bwd})"
                    + ("" if variant == "heads_major" else f"; fed K13's own: rel {r_own:.3e} (tol {SP_CHAIN_TOL})"))
                if not (r_out <= t_out and ok2 and r_dq <= t_bwd and r_own <= SP_CHAIN_TOL):
                    raise SystemExit(f"{k_fwd}/{k_bwd} {where} disagree with their plain versions at rate {rate}")
                r_f["max_abs_err"] = max(r_f["max_abs_err"], e_out, e_2)
                r_b["max_abs_err"] = max(r_b["max_abs_err"], e_dq)
                del out, second, out_r, second_r, dq, dq_r
            rate = 0.1
            if variant == "heads_major":
                out, second = fa.heads_major_attention_fwd(x, key_bias, rate, 5)
                calls = {fwd: lambda f: f(x, key_bias, rate, 5),
                         bwd: lambda f: f(x, key_bias, dout, out, second, rate, 5)}
                moved = {fwd: nbytes(x, key_bias, out), bwd: nbytes(x, key_bias, dout, x)}
            else:
                out, second = fa.packed_attention_sp_fwd(x, key_bias, H, rate, 5)
                calls = {fwd: lambda f: f(x, key_bias, H, rate, 5),
                         bwd: lambda f: f(x, second, dout, out, H, rate, 5)}
                probs_bytes = B * H * T * T * 2  # the [B, H, T, T] bf16 probabilities, not K13's padded rows
                moved = {fwd: nbytes(x, key_bias, out) + probs_bytes, bwd: nbytes(x, dout, out, x) + probs_bytes}
            for name, r in ((fwd, r_f), (bwd, r_b)):
                r["ms"] = cuda_time_ms(lambda: calls[name](getattr(fa, name)), 10)
                r["plain_ms"] = cuda_time_ms(lambda: calls[name](getattr(fa, name + "_reference")), 3)
            r_f["library_ms"], r_b["library_ms"] = sdpa_ms_in(torch, qkv, qb, key_bias, dout_p, H, rate)
            gflop = 2.0 * B * H * T * T * D / 1e9
            peak = FP32_FLOPS if f32 else BF16_FLOPS
            r_f.update(bound(moved[fwd], 2 * gflop * 1e9, peak))
            r_b.update(bound(moved[bwd], 4 * gflop * 1e9, peak))
            geometry = {} if f32 else variant_geometry(lib, fa, variant, x, D)
            for k, (kernel, i) in enumerate(zip(fa.PACKED_KERNELS, variant_info(lib, fa, variant, dtype, D, T))):
                at = ""
                if kernel in geometry:
                    dp, hg, limit = geometry[kernel]
                    at = f" at head dim {dp}: hg {hg}, T up to {limit},"
                log(f"{k_fwd}/{k_bwd} {where} {kernel}{at} {i[0]} registers a thread, {i[1]} bytes of local memory, "
                    f"{i[2]} bytes of shared memory, {i[3]} blocks an SM")
                small = not f32 and (k > 0 or variant == "save_probs") and fa.bwd_head_dim(D) < fa.KERNEL_HEAD_DIM
                if (f32 or small) and i[1] != 0:  # the register-tiled fp32 kernels, K12-K14's small forms
                    raise SystemExit(f"{k_fwd}/{k_bwd} {where}: the {kernel} spills {i[1]} bytes")
            for name, r in ((fwd, r_f), (bwd, r_b)):
                log(row_line(f"{name} {where}", r, card))
                earlier_design_line((name, dtype, D), r["ms"], card)
                rows[(name, dtype, D)] = r
            del x, key_bias, dout, qkv, qb, dout_p, out, second
            torch.cuda.empty_cache()
    for bwd, k_bwd in (("heads_major_attention_bwd", "K12"), ("packed_attention_sp_fwd", "K13"),
                       ("packed_attention_sp_bwd", "K14")):
        for dtype in ("bfloat16", "float16"):
            text = []
            for D in (16, 32):
                r, was = rows[(bwd, dtype, D)], EARLIER_DESIGN_MS[(bwd, dtype, D)]
                text.append(f"D={D} {r['ms']:.4f} ms (SDPA {r['library_ms']:.4f}, {r['ms'] / r['library_ms']:.2f}x; "
                            f"padded to 64 {was:.4f}, {was / r['ms']:.2f}x)")
            log(f"{k_bwd} {dtype} on its small-row forms: " + "; ".join(text) + f"  [{card}]")
    return rows


def check_f32_masks(torch, card):
    """Each fp32 pair's dropout masks (K1/K2, K11/K12, K13/K14) and the bf16
    K1/K2's at the same seed, on tools/attn_ab.py's mask_data (T = 64 keys,
    V and dO the identity, so that the zeros of out and of the dK/dV pass's
    dv are the dropped positions): all must equal the plain mask."""
    from visualbert_torch.ops import _build
    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_ab

    same = attn_ab.f32_masks([attn_ab.F32Build("the port", _build.library())], card)["the port"]
    data = attn_ab.mask_data(torch.bfloat16)
    qkv, qb, key_bias, dout = data["packed"]
    rate, seed, H = attn_ab.MASK_RATE, attn_ab.MASK_SEED, data["H"]
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, seed)
    dqkv, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
    torch.cuda.synchronize()
    same["bf16 K1/K2"] = attn_ab.shows_the_plain_mask("K1/K2", out, dqkv, data)
    log(f"attention masks at T=64, rate {rate}, equal to the plain mask: {same}  [{card}]")
    if not all(same.values()):
        raise SystemExit("the fp32 attention kernels drop other positions than the bf16 kernels")


def layer_norm_inputs_at(torch, dtype, H, N):
    """K7-K10's inputs at N rows of width H in ``dtype``: x, res, dy and
    fp32 scale, bias, from a seeded generator on the device."""
    dev, dt = card_device(torch), getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(H)
    x, res, dy = (torch.randn((N, H), generator=g, device=dev).to(dt) for _ in range(3))
    scale = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    bias = 0.1 * torch.randn(H, generator=g, device=dev)
    return x, res, dy, scale, bias


def check_layer_norm_forms(torch, card):
    """K7-K10 in the forms of LN_FORMS at the main path's N = 29,184 rows,
    held as check_layer_norm holds them (y, dx, dres within LN_Y_TOL; mu,
    rstd within LN_STAT_TOL; dscale, dbias within LN_DW_TOL; K9's bits [N,
    ceil(H / 8)] bit for bit and K10 zero exactly at the plain version's
    zeros), each timed beside its plain version, F.layer_norm on the summed
    input in the form's dtype (K7, K8; none for K9, K10) and its bound,
    printed with each kernel's registers, local bytes, shared bytes and
    blocks an SM. Returns {(wrapper name, dtype, H): table row}."""
    import torch.nn.functional as F

    from visualbert_torch.ops import _build
    from visualbert_torch.ops import layer_norm as ln
    from visualbert_torch.tools.main_path import B, TT, TV

    lib, N, rate, seed, eps, rows = _build.library(), B * (TT + TV), 0.1, 4321, 1e-12, {}
    drop = (rate, seed)
    for dtype, H in LN_FORMS:
        x, res, dy, scale, bias = layer_norm_inputs_at(torch, dtype, H, N)
        code = {"bfloat16": 0, "float16": 1, "float32": 2}[dtype]
        where = f"[{N}, {H}] {dtype} (form {ln.layer_norm_form(x.dtype, H)})"
        for fwd, bwd, args in (("add_layer_norm_fwd", "add_layer_norm_bwd", ()),
                               ("dropout_add_layer_norm_fwd", "dropout_add_layer_norm_bwd", drop)):
            y, mu, rstd, *bits = getattr(ln, fwd)(x, res, scale, bias, *args)
            y_r, mu_r, rstd_r, *bits_r = getattr(ln, fwd + "_reference")(x, res, scale, bias, *args)
            grads = getattr(ln, bwd)(x, res, scale, mu_r, rstd_r, dy, *((bits[0], rate) if args else ()))
            grads_r = getattr(ln, bwd + "_reference")(x, res, scale, mu_r, rstd_r, dy,
                                                      *((bits_r[0], rate) if args else ()))
            torch.cuda.synchronize()
            e_y, r_y = rel_err(y, y_r)
            e_st = max(float((mu - mu_r).abs().max()), float((rstd - rstd_r).abs().max()))
            errs = [rel_err(a, b) for a, b in zip(grads, grads_r)]
            r_d, r_w = max(r for _, r in errs[:-2]), max(r for _, r in errs[-2:])
            same = True
            if args:
                same = (tuple(bits[0].shape) == (N, ln.bits_width(H)) and torch.equal(bits[0], bits_r[0])
                        and torch.equal(grads[0] == 0, grads_r[0] == 0))
            log(f"{fwd}/{bwd} {where}{' rate %g' % rate if args else ''}: y rel {r_y:.3e} (tol {LN_Y_TOL}); mu, "
                f"rstd max_abs_err {e_st:.3e} (tol {LN_STAT_TOL}); dx{', dres' if args else ''} rel {r_d:.3e} "
                f"(tol {LN_Y_TOL}); dscale, dbias rel {r_w:.3e} (tol {LN_DW_TOL})"
                + (f"; keep bits and dropped positions the plain version's: {same}" if args else ""))
            if not (r_y <= LN_Y_TOL and e_st <= LN_STAT_TOL and r_d <= LN_Y_TOL and r_w <= LN_DW_TOL and same):
                raise SystemExit(f"{fwd}/{bwd} {where} disagree with their plain versions")
            rows[(fwd, dtype, H)] = dict(max_abs_err=max(e_y, e_st), **bound(
                nbytes(x, res, scale, bias, y, mu, rstd), LN_OPS[fwd] * N * H, FP32_FLOPS))
            rows[(bwd, dtype, H)] = dict(max_abs_err=max(e for e, _ in errs), **bound(
                nbytes(x, res, scale, mu, rstd, dy, *grads), LN_OPS[bwd] * N * H, FP32_FLOPS))
            del y, y_r, grads, grads_r
        _, mu, rstd, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, *drop)
        calls = {"add_layer_norm_fwd": lambda f: f(x, res, scale, bias),
                 "add_layer_norm_bwd": lambda f: f(x, res, scale, mu, rstd, dy),
                 "dropout_add_layer_norm_fwd": lambda f: f(x, res, scale, bias, *drop),
                 "dropout_add_layer_norm_bwd": lambda f: f(x, res, scale, mu, rstd, dy, bits, rate)}
        for name, call in calls.items():
            rows[(name, dtype, H)]["ms"] = cuda_time_ms(lambda: call(getattr(ln, name)), 20)
            rows[(name, dtype, H)]["plain_ms"] = cuda_time_ms(lambda: call(getattr(ln, name + "_reference")), 3)
        s_in = x + res
        w, b = scale.to(x.dtype), bias.to(x.dtype)
        rows[("add_layer_norm_fwd", dtype, H)]["library_ms"] = cuda_time_ms(
            lambda: F.layer_norm(s_in, (H,), w, b, eps), 20)
        leaves = [t.detach().clone().requires_grad_(True) for t in (s_in, w, b)]
        yl = F.layer_norm(leaves[0], (H,), leaves[1], leaves[2], eps)
        rows[("add_layer_norm_bwd", dtype, H)]["library_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(yl, leaves, dy, retain_graph=True), 20)
        for name in ("dropout_add_layer_norm_fwd", "dropout_add_layer_norm_bwd"):
            rows[(name, dtype, H)]["library_ms"] = None
        for kernel, name in zip((7, 8, 9, 10), calls):
            regs, local, smem, per_sm = (lib.vb_ln_info(kernel, what, H, code) for what in range(4))
            log(f"K{kernel} {where}: {regs} registers a thread, {local} bytes of local memory, {smem} bytes of "
                f"shared memory, {per_sm} blocks an SM")
            log(row_line(f"{name} {where}", rows[(name, dtype, H)], card))
        del x, res, dy, scale, bias, mu, rstd, bits, s_in, leaves, yl
        torch.cuda.empty_cache()
    return rows


def geometry_per_step(cfg):
    """Launches of K1..K14, K15/K16 and the site kernels a train step of
    coco_pretrain at ``cfg``'s depth L (the LABELS order): L each of the
    attention pair its flags select (K1/K2; K11/K12 with packed_qkv false;
    K13/K14 with flash_save_probs), K4-K6 one each with fused_mlm_xent; with
    the fused LayerNorm 2L K9/K10 and one dropout site (the embeddings'),
    without it 2L + 1 sites."""
    L = cfg.num_hidden_layers
    n = [0] * len(LABELS)
    fwd = 10 if not cfg.packed_qkv else (12 if cfg.flash_save_probs else 0)
    n[fwd] = n[fwd + 1] = L
    if cfg.fused_mlm_xent:
        n[3] = n[4] = n[5] = 1
    if cfg.use_fused_layer_norm:
        n[8] = n[9] = 2 * L
        n[18] = n[19] = 1
    else:
        n[18] = n[19] = 2 * L + 1
    return n


def geometry_forms(cfg, want):
    """{wrapper name: {form: launches}} that a run of ``want`` launches (the
    LABELS order) at ``cfg``'s dtype and widths must count, for every
    wrapper that counts forms (K1, K2, K4-K14)."""
    from visualbert_torch.ops.flash_attention import attention_form, bwd_attention_form, sp_attention_form
    from visualbert_torch.ops.layer_norm import layer_norm_form
    from visualbert_torch.ops.mlm_xent import xent_form

    a_form, l_form = attention_form(cfg.dtype, cfg.head_dim), layer_norm_form(cfg.dtype, cfg.hidden_size)
    b_form = bwd_attention_form(cfg.dtype, cfg.head_dim)
    sp_form = sp_attention_form(cfg.dtype, cfg.head_dim)
    x_form = xent_form(cfg.dtype, cfg.hidden_size) if cfg.fused_mlm_xent else None
    form_of = {0: a_form, 1: b_form, 3: x_form, 4: x_form, 5: x_form, 6: l_form, 7: l_form, 8: l_form, 9: l_form,
               10: a_form, 11: b_form, 12: sp_form, 13: b_form}
    return {KERNELS[i][0]: ({f: want[i]} if want[i] else {}) for i, f in form_of.items()}


def run_geometry_cli(torch, card):
    """Phase 27: GEOMETRY_EXAMPLES / 128 train steps of coco_pretrain through
    the CLI on synthetic data, with configs/coco_pretrain.json's blocks and
    flags, in each model geometry of GEOMETRIES: the run must be on cuda,
    its losses finite, its launches geometry_per_step's, each launch of
    K1/K2, K4-K6, K7-K10 and K11-K14 in the form of its dtype and widths
    (geometry_forms). Prints each run's
    median step time (steps 2.., a step timed with a synchronise on either
    side) and peak memory. Returns {label: (config, forms, median step ms)}."""
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.train.trainer import Trainer
    from visualbert_torch.utils.config_io import load_config_file

    out = {}
    for label, fields in GEOMETRIES:
        raw = load_config_file(CONFIG)
        d = raw["data"]
        raw["data"] = dict({k: d[k] for k in ("max_seq_length", "max_regions", "two_sentence")},
                           synthetic=GEOMETRY_EXAMPLES)
        raw["model"] = dict(raw["model"], **fields)
        raw["train"] = dict(raw["train"], num_train_epochs=1)
        folder = tempfile.mkdtemp(prefix="chip_smoke_geometry_")
        times, train_step = [], Trainer.train_step

        def timed(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(self, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return metrics

        Trainer.train_step = timed
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            trainer, result, summary = run_cli_quiet(["--config", write_config(folder, "geometry.json", raw),
                                                      "--folder", os.path.join(folder, "run")])
            launches, forms = read_launches(), read_forms()
        finally:
            Trainer.train_step = train_step
            shutil.rmtree(folder, ignore_errors=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg, steps = trainer.model.cfg, trainer.step
        epoch = result.history[0]
        want = [n * steps for n in geometry_per_step(cfg)]
        want_forms = geometry_forms(cfg, want)
        med = statistics.median(times[1:]) if len(times) > 1 else times[0]
        log(f"geometry {label}: {summary}; {steps} steps at batch {raw['train']['train_batch_size']} on "
            f"{trainer.device}, {cfg.dtype}, hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads of "
            f"{cfg.head_dim}, {cfg.num_hidden_layers} layers; epoch means: "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(epoch.items())))
        log(f"geometry {label}: launches " + launch_text(launches) + f"; want {'/'.join(map(str, want))}; forms "
            f"{json.dumps(forms)}")
        log(f"geometry {label}: step time median {med * 1e3:.2f} ms over steps 2..{steps} (first "
            f"{times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB  [{card}]")
        if trainer.device.type != "cuda" or steps != GEOMETRY_EXAMPLES // raw["train"]["train_batch_size"]:
            raise SystemExit(f"geometry {label}: {steps} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit(f"geometry {label}: non-finite loss")
        if launches != want or forms != want_forms:
            raise SystemExit(f"geometry {label}: launches {launches}, forms {forms}; want {want}, {want_forms}")
        if cfg.fused_mlm_xent and cfg.hidden_size > 1024 and not all(
                f.split()[1] == "wide" for k in ("mlm_xent_fwd", "mlm_xent_dx", "mlm_xent_de") for f in forms[k]):
            raise SystemExit(f"geometry {label}: K4-K6 ran {forms}, not the wide form")
        out[label] = (cfg, forms, med * 1e3)
        del trainer, result
        torch.cuda.empty_cache()
    return out


def check_layer_norm(torch, card):
    """K7-K10 against their plain versions at the main path's rows: y and
    dx/dres by max |kernel - plain| / max |plain|, mu/rstd by absolute
    error, dscale/dbias by relative error; K9's keep bits must equal the
    plain bits and K10's dropped positions the plain version's exactly (the
    same Philox bits). K10 runs on K9's saved bits, as the model does. The
    library yardstick is F.layer_norm on the precomputed bf16 sum and its
    autograd backward; K9/K10 have no single-call counterpart. K9/K10 are
    printed with their registers, local bytes (neither may spill), shared
    bytes, blocks an SM, the backward's ring stages and achieved TB/s,
    beside their first design's times and a device-to-device copy of K10's
    byte count."""
    import torch.nn.functional as F

    from visualbert_torch.ops import _build
    from visualbert_torch.ops import layer_norm as ln
    from visualbert_torch.tools.main_path import layer_norm_inputs

    rate, seed, eps = 0.1, 4321, 1e-12
    dev = torch.device("cuda")
    x, res, dy, scale, bias = layer_norm_inputs(dev)
    N, H = x.shape
    drop = (rate, seed)
    rows = {}
    for fwd, bwd, args in (("add_layer_norm_fwd", "add_layer_norm_bwd", ()),
                           ("dropout_add_layer_norm_fwd", "dropout_add_layer_norm_bwd", drop)):
        y, mu, rstd, *bits = getattr(ln, fwd)(x, res, scale, bias, *args)
        y_r, mu_r, rstd_r, *bits_r = getattr(ln, fwd + "_reference")(x, res, scale, bias, *args)
        # the backward of both sides gets the plain mu and rstd, K10 K9's bits
        grads = getattr(ln, bwd)(x, res, scale, mu_r, rstd_r, dy, *((bits[0], rate) if args else ()))
        grads_r = getattr(ln, bwd + "_reference")(x, res, scale, mu_r, rstd_r, dy, *((bits_r[0], rate) if args else ()))
        torch.cuda.synchronize()
        e_y, r_y = rel_err(y, y_r)
        e_st = max(float((mu - mu_r).abs().max()), float((rstd - rstd_r).abs().max()))
        errs = [rel_err(a, b) for a, b in zip(grads, grads_r)]  # dx, (dres,) dscale, dbias
        r_d = max(r for _, r in errs[:-2])
        r_w = max(r for _, r in errs[-2:])
        log(f"{fwd} [{N}, {H}] bf16{' rate %g' % rate if args else ''}: y max_abs_err {e_y:.3e} "
            f"(rel {r_y:.3e}, tol {LN_Y_TOL}); mu, rstd max_abs_err {e_st:.3e} (tol {LN_STAT_TOL})")
        log(f"{bwd}: dx{', dres' if args else ''} rel {r_d:.3e} (tol {LN_Y_TOL}); dscale, dbias rel {r_w:.3e} "
            f"(tol {LN_DW_TOL})")
        if not (r_y <= LN_Y_TOL and e_st <= LN_STAT_TOL and r_d <= LN_Y_TOL and r_w <= LN_DW_TOL):
            raise SystemExit(f"{fwd}/{bwd} disagree with their plain versions")
        if args:
            same_bits = torch.equal(bits[0], bits_r[0])
            dropped, dropped_r = grads[0] == 0, grads_r[0] == 0
            same = torch.equal(dropped, dropped_r)
            share = float(dropped_r.float().mean())
            log(f"{fwd}: keep bits [{N}, {H // 8}] uint8 equal to the plain version's packed mask: {same_bits}")
            log(f"{bwd}: dx zero at the plain version's dropped positions exactly: {same} "
                f"(dropped share {share:.6f}, rate {rate})")
            if not (same and same_bits):
                raise SystemExit("K9/K10's dropout mask differs from the plain version's")
        rows[fwd] = dict(max_abs_err=max(e_y, e_st),
                         **bound(nbytes(x, res, scale, bias, y, mu, rstd), LN_OPS[fwd] * N * H, FP32_FLOPS))
        # K10's bound counts the JAX function's bytes; the keep bits are the design's own traffic
        rows[bwd] = dict(max_abs_err=max(e for e, _ in errs),
                         **bound(nbytes(x, res, scale, mu, rstd, dy, *grads), LN_OPS[bwd] * N * H, FP32_FLOPS))
        del y_r, grads_r

    # times at the main path's rows; the backward timings reuse K9's mu,
    # rstd and K10 K9's saved keep bits
    _, mu, rstd, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, *drop)
    fns = {
        "add_layer_norm_fwd": lambda f: f(x, res, scale, bias),
        "add_layer_norm_bwd": lambda f: f(x, res, scale, mu, rstd, dy),
        "dropout_add_layer_norm_fwd": lambda f: f(x, res, scale, bias, *drop),
        "dropout_add_layer_norm_bwd": lambda f: f(x, res, scale, mu, rstd, dy, bits, rate),
    }
    host_us = {}
    for name, call in fns.items():
        rows[name]["ms"] = cuda_time_ms(lambda: call(getattr(ln, name)), 50)
        rows[name]["plain_ms"] = cuda_time_ms(lambda: call(getattr(ln, name + "_reference")), 5)
        host_us[name] = host_us_a_call(torch, lambda: call(getattr(ln, name)), 50)
    # a wrapper's host time a call at or above its kernel's time makes the
    # events above time the host
    log("K7-K10 wrappers' host time a call (enqueue only): " + ", ".join(
        f"{name} {us:.1f} us against {rows[name]['ms'] * 1e3:.1f} us timed" for name, us in host_us.items())
        + f"  [{card}]")
    s = x + res
    w16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    rows["add_layer_norm_fwd"]["library_ms"] = cuda_time_ms(lambda: F.layer_norm(s, (H,), w16, b16, eps), 50)
    leaves = [t.detach().clone().requires_grad_(True) for t in (s, w16, b16)]
    yl = F.layer_norm(leaves[0], (H,), leaves[1], leaves[2], eps)
    rows["add_layer_norm_bwd"]["library_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(yl, leaves, dy, retain_graph=True), 50)
    rows["dropout_add_layer_norm_fwd"]["library_ms"] = rows["dropout_add_layer_norm_bwd"]["library_ms"] = None
    del s, leaves, yl
    for name, r in rows.items():
        log(row_line(name, r, card))

    # the design's facts, beside the first design's times and a copy of K10's bytes
    lib = _build.library()
    # y like x; dx, dres, dscale, dbias like x, res, scale, bias
    moved = {"dropout_add_layer_norm_fwd": nbytes(x, res, scale, bias, x, mu, rstd, bits),
             "dropout_add_layer_norm_bwd": nbytes(x, res, scale, mu, rstd, dy, bits, x, res, scale, bias)}
    for kernel, name in ((9, "dropout_add_layer_norm_fwd"), (10, "dropout_add_layer_norm_bwd")):
        regs, local, smem, per_sm = (lib.vb_ln_info(kernel, w, H, 0) for w in range(4))
        stages = lib.vb_ln_geometry(2) if kernel == 10 else 0
        ms, first = rows[name]["ms"], LN_FIRST_DESIGN_MS[name]
        log(f"K{kernel} {name} [{N}, {H}] bf16: {regs} registers a thread, {local} bytes of local memory, {smem} "
            f"bytes of shared memory, {per_sm} blocks an SM, {stages} ring stages a warp; {ms:.4f} ms, "
            f"{moved[name] / ms / 1e9:.3f} TB/s achieved (its {moved[name] / 1e6:.1f} MB, keep bits included); "
            f"first design (earlier runs) {first[0]:.4f}-{first[1]:.4f} ms: faster than its least reading: "
            f"{ms < first[0]}  [{card}]")
        if local:
            raise SystemExit(f"K{kernel} spills to local memory")
    # yardstick, not the function and not library_ms: a device-to-device
    # copy that moves K10's bytes (half read, half written)
    src = torch.empty(moved["dropout_add_layer_norm_bwd"] // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms_copy = cuda_time_ms(lambda: dst.copy_(src), 50)
    ms10 = rows["dropout_add_layer_norm_bwd"]["ms"]
    log(f"yardstick: a device-to-device copy of K10's {2 * src.numel() / 1e6:.1f} MB (not the function): "
        f"{ms_copy:.4f} ms, {2 * src.numel() / ms_copy / 1e9:.3f} TB/s; K10 {ms10:.4f} ms, "
        f"{ms_copy / ms10:.1%} of the copy's rate  [{card}]")
    del src, dst
    return rows


def check_slice_reference(torch, model_block, what="bert-base bf16", tol=SLICE_REL_TOL):
    """The kernel path (K1/K2 attention, K4-K6 cross-entropy), the same with
    the fused LayerNorm (K7/K8, dropout off), with the heads-major attention
    (K11/K12, packed_qkv false), with the saved probabilities (K13/K14) and
    the einsum attention with the unfused decoder and eager LayerNorm, on
    the same 2-layer weights of ``model_block``'s width, dropout off: the
    losses must agree within ``tol``. K11-K14 take bf16 at head dim 64
    only: in another dtype or head dim their two paths are left out."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.from_dict(model_block).replace(num_hidden_layers=2)
    batch = to_device(synth_batch(8, seed=3, vocab=cfg.vocab_size), "cuda")
    paths = {"kernel path": dict(use_flash_attention=True, fused_mlm_xent=True, use_fused_layer_norm=False),
             "kernel path with fused LayerNorm": dict(use_flash_attention=True, fused_mlm_xent=True,
                                                      use_fused_layer_norm=True),
             "heads-major kernel path": dict(use_flash_attention=True, fused_mlm_xent=True, packed_qkv=False),
             "save-probs kernel path": dict(use_flash_attention=True, fused_mlm_xent=True, flash_save_probs=True),
             "einsum + unfused path": dict(use_flash_attention=False, fused_mlm_xent=False,
                                           use_fused_layer_norm=False)}
    if cfg.dtype != torch.bfloat16 or cfg.head_dim != 64:
        del paths["heads-major kernel path"], paths["save-probs kernel path"]
    losses = {}
    for name, flags in paths.items():
        m = VisualBertForTask(cfg.replace(**flags), "pretraining")
        m.init_weights(torch.Generator().manual_seed(5)).to("cuda")
        with torch.no_grad():
            out = m(batch)
        losses[name] = (float(out["loss"]), float(out["masked_lm_loss"]))
    want = losses["einsum + unfused path"]
    worst = 0.0
    for name, got in losses.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        worst = max(worst, *rel)
        log(f"slice reference ({what}, 2 layers, B=8, dropout off): {name} loss {got[0]:.6f} (MLM {got[1]:.6f}), "
            f"rel diff to the einsum + unfused path {rel[0]:.2e} / {rel[1]:.2e} (tol {tol})")
    if not worst <= tol:
        raise SystemExit(f"the kernel paths and the einsum + unfused path disagree ({what})")


def run_slice(torch, block, card, per_step, what):
    """STEPS train steps of the main path built from ``block``; returns the
    launches of K1..K14 and the step's median time, pairs/s and peak memory."""
    from visualbert_torch.tools.main_path import B, build

    trainer, batch = build(block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        loss = float(metrics["loss"])  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"{what}: losses ({STEPS} steps, one repeated batch): " + ", ".join(f"{x:.5f}" for x in losses))
    log(f"{what}: launches over {STEPS} steps: "
        + ", ".join(f"{label} {n} ({n / STEPS:g}/step)" for label, n in zip(LABELS, launches))
        + f"; want {'/'.join(map(str, per_step))} per step")
    med = statistics.median(times[1:])
    log(f"{what}: step time median {med * 1e3:.2f} ms over steps 2..{STEPS} (first step {times[0] * 1e3:.1f} ms), "
        f"{B / med:.1f} pairs/s, peak memory {peak_gb:.2f} GiB  [{card}]")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{what}: non-finite loss")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{what}: loss did not fall on the repeated batch")
    if launches != [n * STEPS for n in per_step]:
        raise SystemExit(f"{what}: unexpected kernel launch counts {launches}")
    return launches, dict(median_ms=med * 1e3, pairs_per_s=B / med, peak_gib=peak_gb)


def run_step_without_dropout(torch, block):
    """One train step of the main path built from ``block`` with both
    dropout rates 0: the fused LayerNorm runs as K7/K8."""
    from visualbert_torch.tools.main_path import build

    trainer, batch = build(dict(block, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    zero_launches()
    loss = float(trainer.train_step(batch)["loss"])
    launches = read_launches()
    log("main path, dropout 0, one step: loss %.5f; launches " % loss + launch_text(launches)
        + f"; want {'/'.join(map(str, NO_DROPOUT_PER_STEP))}")
    if not math.isfinite(loss) or launches != list(NO_DROPOUT_PER_STEP):
        raise SystemExit(f"the dropout-0 step: loss {loss}, launches {launches}")
    return launches


def run_cli(torch, card):
    """One epoch of a synthetic COCO set through the training CLI, with the
    model, optimizer and train blocks of configs/coco_pretrain.json."""
    from visualbert_torch import train_cli
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.train.trainer import Trainer
    from visualbert_torch.utils.checkpoint import CheckpointManager
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(CONFIG)
    d = raw["data"]
    raw["data"] = dict({k: d[k] for k in ("max_seq_length", "max_regions", "two_sentence")}, synthetic=CLI_EXAMPLES)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        path = os.path.join(folder, "coco_synthetic.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        out = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer, result = train_cli.main(["--config", path, "--folder", os.path.join(folder, "run")])
        wall = time.perf_counter() - t0
        launches = read_launches()
        steps = trainer.step
        epoch = result.history[0]
        log(f"cli: {out.getvalue().strip()}; {steps} steps at batch {raw['train']['train_batch_size']} on "
            f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(epoch.items())))
        log("cli launches: " + launch_text(launches)
            + f"; want {'/'.join(map(str, PER_STEP))} per step")
        if trainer.device.type != "cuda" or steps != CLI_EXAMPLES // raw["train"]["train_batch_size"]:
            raise SystemExit(f"the CLI ran {steps} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite loss in the CLI run")
        if launches != [n * steps for n in PER_STEP]:
            raise SystemExit(f"unexpected kernel launch counts in the CLI run {launches}")

        ckpt = CheckpointManager(os.path.join(folder, "run", "ckpt"))
        fresh = Trainer(VisualBertForTask(trainer.model.cfg, "pretraining"), trainer.opt_config,
                        trainer.train_config, device="cuda").init_state()
        ckpt.restore(fresh)
        same = [torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                    fresh.model.state_dict().values())]
        same += [torch.equal(trainer.optimizer.m[k], fresh.optimizer.m[k])
                 and torch.equal(trainer.optimizer.v[k], fresh.optimizer.v[k]) for k in trainer.optimizer.m]
        log(f"cli checkpoint {os.path.basename(ckpt.path())}: {sum(same)} of {len(same)} tensors "
            f"(weights, BertAdam moments) equal after reload, step {fresh.step}")
        if not all(same) or fresh.step != steps or fresh.optimizer.step_count != steps:
            raise SystemExit("the CLI's checkpoint does not reload bit for bit")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_vqa_cli(torch, card):
    """VQA fine-tuning through the CLI on a synthetic set, with the model,
    optimizer and train blocks of configs/vqa_finetune.json and the fused
    LayerNorm on; then --eval_only of its checkpoint."""
    from visualbert_torch import train_cli
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(VQA_CONFIG)
    raw["data"] = {"synthetic": VQA_EXAMPLES, "max_seq_length": 128, "max_regions": 100}
    raw["model"] = dict(raw["model"], use_fused_layer_norm=True)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    n_train = int(VQA_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_batches = -(-(VQA_EXAMPLES - n_train) // raw["train"]["eval_batch_size"])
    folder = tempfile.mkdtemp(prefix="chip_smoke_vqa_")
    try:
        path = os.path.join(folder, "vqa_synthetic.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        run = os.path.join(folder, "run")
        out = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer, result = train_cli.main(["--config", path, "--folder", run])
        wall = time.perf_counter() - t0
        launches = read_launches()
        epoch = result.history[0]
        # the epoch's evaluation and the prediction dump after fit each run the eval split
        want = [steps * a + 2 * eval_batches * b for a, b in zip(VQA_TRAIN_PER_STEP, VQA_EVAL_PER_BATCH)]
        log(f"vqa cli: {out.getvalue().strip()}; {trainer.step} steps at batch {raw['train']['train_batch_size']} "
            f"on {trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
        log("vqa cli launches: " + launch_text(launches)
            + f"; want {steps} x {'/'.join(map(str, VQA_TRAIN_PER_STEP))} (train steps) + 2 x {eval_batches} x "
            + f"{'/'.join(map(str, VQA_EVAL_PER_BATCH))} (eval batches)")
        if trainer.device.type != "cuda" or trainer.step != steps:
            raise SystemExit(f"the VQA CLI ran {trainer.step} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite metric in the VQA CLI run")
        if launches != want:
            raise SystemExit(f"unexpected kernel launch counts in the VQA CLI run {launches}")
        with open(os.path.join(run, "vqa_predictions.json")) as f:
            preds = json.load(f)
        if [p["question_id"] for p in preds] != list(range(n_train, VQA_EXAMPLES)):
            raise SystemExit("vqa_predictions.json does not hold one entry per eval question")
        del trainer, result
        torch.cuda.empty_cache()

        again = os.path.join(folder, "eval")
        out = io.StringIO()
        zero_launches()
        with contextlib.redirect_stdout(out):
            _, result = train_cli.main(["--config", path, "--folder", again, "--eval_only",
                                        "--restore", os.path.join(run, "ckpt")])
        launches = read_launches()
        metrics = result.history[0]
        diff = max(abs(metrics[k] - epoch["val_" + k]) for k in ("loss", "accuracy"))
        with open(os.path.join(again, "vqa_predictions.json")) as f:
            same_preds = json.load(f) == preds
        log(f"vqa --eval_only: {out.getvalue().strip()}; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            + f"; max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6); predictions equal: {same_preds} "
            f"({len(preds)} questions); launches " + launch_text(launches))
        if diff > 1e-6 or not same_preds or launches != [eval_batches * b for b in VQA_EVAL_PER_BATCH]:
            raise SystemExit("--eval_only does not reproduce the VQA run's evaluation")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_nlvr2_cli(torch, card):
    """NLVR2 fine-tuning through the CLI on a synthetic set of NLVR2_EXAMPLES
    image pairs (80 % train, 20 % eval; 128 text tokens + 2 x 72 regions, T
    = 272), with the model, optimizer and train blocks of
    configs/nlvr2_finetune.json and `"flash_save_probs": true` added to its
    model block; one epoch at its batch of 64. Then --eval_only of its
    checkpoint."""
    from visualbert_torch import train_cli
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(NLVR2_CONFIG)
    raw["data"] = {"synthetic": NLVR2_EXAMPLES, "max_seq_length": 128, "max_regions_per_image": 72}
    raw["model"] = dict(raw["model"], flash_save_probs=True)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    n_train = int(NLVR2_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_bs = raw["train"].get("eval_batch_size", 32)  # TrainConfig's default
    eval_batches = -(-(NLVR2_EXAMPLES - n_train) // eval_bs)
    folder = tempfile.mkdtemp(prefix="chip_smoke_nlvr2_")
    try:
        path = os.path.join(folder, "nlvr2_synthetic.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        run = os.path.join(folder, "run")
        out = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer, result = train_cli.main(["--config", path, "--folder", run])
        wall = time.perf_counter() - t0
        launches = read_launches()
        epoch = result.history[0]
        # the epoch's evaluation and the report after fit each run the eval split
        want = [steps * a + 2 * eval_batches * b for a, b in zip(NLVR2_TRAIN_PER_STEP, NLVR2_EVAL_PER_BATCH)]
        log(f"nlvr2 cli: {out.getvalue().strip()}; {trainer.step} steps at batch "
            f"{raw['train']['train_batch_size']} on {trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
        log("nlvr2 cli launches: " + launch_text(launches)
            + f"; want {steps} x {'/'.join(map(str, NLVR2_TRAIN_PER_STEP))} (train steps) + 2 x {eval_batches} x "
            + f"{'/'.join(map(str, NLVR2_EVAL_PER_BATCH))} (eval batches)")
        if trainer.device.type != "cuda" or trainer.step != steps:
            raise SystemExit(f"the NLVR2 CLI ran {trainer.step} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite metric in the NLVR2 CLI run")
        if launches != want:
            raise SystemExit(f"unexpected kernel launch counts in the NLVR2 CLI run {launches}")
        with open(os.path.join(run, "nlvr2_report.csv")) as f:
            report = f.read()
        if [line.split(",")[0] for line in report.splitlines()] != sorted(map(str, range(n_train, NLVR2_EXAMPLES))):
            raise SystemExit("nlvr2_report.csv does not hold one row per eval identifier")
        del trainer, result
        torch.cuda.empty_cache()

        again = os.path.join(folder, "eval")
        out = io.StringIO()
        zero_launches()
        with contextlib.redirect_stdout(out):
            _, result = train_cli.main(["--config", path, "--folder", again, "--eval_only",
                                        "--restore", os.path.join(run, "ckpt")])
        launches = read_launches()
        metrics = result.history[0]
        diff = max(abs(metrics[k] - epoch["val_" + k]) for k in ("loss", "accuracy"))
        with open(os.path.join(again, "nlvr2_report.csv")) as f:
            same = f.read() == report
        # the official scores are functions of the report, equal to the
        # trained run's; on synthetic identifiers (one pair a sentence group)
        # both must equal the epoch's weighted accuracy
        d_off = abs(metrics["official_accuracy"] - epoch["val_accuracy"])
        log(f"nlvr2 --eval_only: {out.getvalue().strip()}; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            + f"; max |diff| of loss and accuracy to the epoch's val_ metrics {diff:.2e} (tol 1e-6); report equal: "
            f"{same} ({len(report.splitlines())} rows); |official accuracy - val_accuracy| {d_off:.2e} (tol 1e-6), "
            f"consistency equal to it: {metrics['consistency'] == metrics['official_accuracy']}; launches "
            + launch_text(launches))
        if diff > 1e-6 or not same or launches != [eval_batches * b for b in NLVR2_EVAL_PER_BATCH]:
            raise SystemExit("--eval_only does not reproduce the NLVR2 run's evaluation")
        if d_off > 1e-6 or metrics["consistency"] != metrics["official_accuracy"]:
            raise SystemExit("the NLVR2 official scores disagree with the weighted accuracy")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_cli_quiet(argv):
    """train_cli.main(argv) with its stdout captured: (trainer, result, the
    printed summary line)."""
    from visualbert_torch import train_cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer, result = train_cli.main(argv)
    return trainer, result, out.getvalue().strip()


def write_config(folder, name, raw):
    path = os.path.join(folder, name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def run_vqa_advanced_cli(torch, card):
    """VQA answer-as-MLM through the CLI: configs/vqa_finetune.json with
    `"task": "vqa_advanced"`, `"fused_mlm_xent": true` and
    `"use_fused_layer_norm": true` added, on VQA_EXAMPLES synthetic
    questions, one epoch at its batch of 64; then --eval_only of its
    checkpoint."""
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(VQA_CONFIG)
    raw["task"] = "vqa_advanced"
    raw["data"] = {"synthetic": VQA_EXAMPLES, "max_seq_length": 128, "max_regions": 100}
    raw["model"] = dict(raw["model"], fused_mlm_xent=True, use_fused_layer_norm=True)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    n_train = int(VQA_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_batches = -(-(VQA_EXAMPLES - n_train) // raw["train"]["eval_batch_size"])
    folder = tempfile.mkdtemp(prefix="chip_smoke_vqa_advanced_")
    try:
        path = write_config(folder, "vqa_advanced_synthetic.json", raw)
        run = os.path.join(folder, "run")
        zero_launches()
        t0 = time.perf_counter()
        trainer, result, printed = run_cli_quiet(["--config", path, "--folder", run])
        wall = time.perf_counter() - t0
        launches = read_launches()
        epoch = result.history[0]
        # the epoch's evaluation and the prediction dump after fit each run the eval split
        want = [steps * a + 2 * eval_batches * b for a, b in zip(VQA_ADVANCED_TRAIN_PER_STEP, VQA_EVAL_PER_BATCH)]
        log(f"vqa_advanced cli: {printed}; {trainer.step} steps at batch {raw['train']['train_batch_size']} on "
            f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
        log("vqa_advanced cli launches: " + launch_text(launches)
            + f"; want {steps} x {'/'.join(map(str, VQA_ADVANCED_TRAIN_PER_STEP))} (train steps: K4/K5/K6 1/1/1) "
            + f"+ 2 x {eval_batches} x {'/'.join(map(str, VQA_EVAL_PER_BATCH))} (eval batches: no K4-K6)")
        if trainer.device.type != "cuda" or trainer.step != steps:
            raise SystemExit(f"the vqa_advanced CLI ran {trainer.step} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite metric in the vqa_advanced CLI run")
        if launches != want:
            raise SystemExit(f"unexpected kernel launch counts in the vqa_advanced CLI run {launches}")
        with open(os.path.join(run, "vqa_advanced_predictions.json")) as f:
            preds = json.load(f)
        if [p["question_id"] for p in preds] != list(range(n_train, VQA_EXAMPLES)):
            raise SystemExit("vqa_advanced_predictions.json does not hold one entry per eval question")
        del trainer, result
        torch.cuda.empty_cache()

        again = os.path.join(folder, "eval")
        zero_launches()
        _, result, printed = run_cli_quiet(["--config", path, "--folder", again, "--eval_only",
                                            "--restore", os.path.join(run, "ckpt")])
        launches = read_launches()
        metrics = result.history[0]
        diff = max(abs(metrics[k] - epoch["val_" + k]) for k in ("loss", "masked_lm_loss", "mlm_accuracy"))
        with open(os.path.join(again, "vqa_advanced_predictions.json")) as f:
            same_preds = json.load(f) == preds
        log(f"vqa_advanced --eval_only: {printed}; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            + f"; max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6); predictions equal: {same_preds} "
            f"({len(preds)} questions); launches " + launch_text(launches))
        if diff > 1e-6 or not same_preds or launches != [eval_batches * b for b in VQA_EVAL_PER_BATCH]:
            raise SystemExit("--eval_only does not reproduce the vqa_advanced run's evaluation")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_flickr_cli(torch, card, folder):
    """Flickr30k grounding through the CLI: configs/flickr_finetune.json with
    its data block swapped for FLICKR_EXAMPLES synthetic captions (80 %
    train, 20 % eval; 128 text tokens + 100 regions, 16 entity slots), one
    epoch at its batch of 32; then --eval_only of its checkpoint. Returns
    the checkpoint directory."""
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(FLICKR_CONFIG)
    raw["data"] = FLICKR_DATA
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    n_train = int(FLICKR_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_batches = -(-(FLICKR_EXAMPLES - n_train) // raw["train"]["eval_batch_size"])
    path = write_config(folder, "flickr_synthetic.json", raw)
    run = os.path.join(folder, "run")
    zero_launches()
    t0 = time.perf_counter()
    trainer, result, printed = run_cli_quiet(["--config", path, "--folder", run])
    wall = time.perf_counter() - t0
    launches = read_launches()
    epoch = result.history[0]
    want = [steps * a + 2 * eval_batches * b for a, b in zip(FLICKR_TRAIN_PER_STEP, FLICKR_EVAL_PER_BATCH)]
    log(f"flickr cli: {printed}; {trainer.step} steps at batch {raw['train']['train_batch_size']} on "
        f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
        + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
    log("flickr cli launches: " + launch_text(launches)
        + f"; want {steps} x {'/'.join(map(str, FLICKR_TRAIN_PER_STEP))} (train steps) + 2 x {eval_batches} x "
        + f"{'/'.join(map(str, FLICKR_EVAL_PER_BATCH))} (eval batches)")
    if trainer.device.type != "cuda" or trainer.step != steps:
        raise SystemExit(f"the flickr CLI ran {trainer.step} steps on {trainer.device}")
    if not all(math.isfinite(v) for v in epoch.values()):
        raise SystemExit("non-finite metric in the flickr CLI run")
    if launches != want:
        raise SystemExit(f"unexpected kernel launch counts in the flickr CLI run {launches}")
    del trainer, result
    torch.cuda.empty_cache()

    zero_launches()
    _, result, printed = run_cli_quiet(["--config", path, "--folder", os.path.join(folder, "eval"), "--eval_only",
                                        "--restore", os.path.join(run, "ckpt")])
    launches = read_launches()
    metrics = result.history[0]
    diff = max(abs(metrics[k] - epoch["val_" + k]) for k in ("loss", "accuracy", "upperbound_accuracy"))
    recall = [metrics[f"recall_at_{k}"] for k in (1, 5, 10)]
    log(f"flickr --eval_only: {printed}; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
        + f"; max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6); R@1/5/10 {recall} in [0, 1] and "
        f"not falling in k: {all(0 <= r <= 1 for r in recall) and recall == sorted(recall)}; launches "
        + launch_text(launches))
    if diff > 1e-6 or launches != [eval_batches * b for b in FLICKR_EVAL_PER_BATCH]:
        raise SystemExit("--eval_only does not reproduce the flickr run's evaluation")
    if not (all(0 <= r <= 1 for r in recall) and recall == sorted(recall)):
        raise SystemExit(f"flickr R@1/5/10 out of order or range: {recall}")
    return os.path.join(run, "ckpt")


def run_flickr_probe_cli(torch, card, folder, ckpt):
    """The attention probe through the CLI: configs/flickr_probe.json with
    the flickr phase's synthetic data block (the whole set is the split, in
    eval batches of 16: the last one padded), --restore the flickr phase's
    checkpoint. Its per-layer hits must equal a recomputation from one
    [L, B, H, T, T] collection of the whole split, and it must launch no
    kernel (einsum attention, no dropout)."""
    import numpy as np

    from visualbert_torch.data.datasets import flickr
    from visualbert_torch.data.pipeline import Batcher
    from visualbert_torch.tasks import registry
    from visualbert_torch.tasks.probing import entity_region_attention, grounding_counts_from_era
    from visualbert_torch.utils.config_io import load_config_file, parse_task_config

    raw = load_config_file(PROBE_CONFIG)
    raw["data"] = FLICKR_DATA
    path = write_config(folder, "flickr_probe_synthetic.json", raw)
    out = os.path.join(folder, "probe")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    trainer, result, printed = run_cli_quiet(["--config", path, "--folder", out, "--restore", ckpt])
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out, "flickr_probe.json")) as f:
        probe = json.load(f)
    layers = [probe[f"layer_{i}"] for i in range(sum(k.startswith("layer_") for k in probe))]
    bs = raw["train"]["eval_batch_size"]
    log(f"flickr_probe cli: {printed}; {FLICKR_EXAMPLES} captions in eval batches of {bs} on {trainer.device}, "
        f"{wall:.1f} s with set-up, peak memory {peak:.2f} GiB  [{card}]; {probe['entities']} entities, accuracy "
        "by layer " + ", ".join(f"{a:.4f}" for a in layers) + "; launches " + launch_text(launches))
    if trainer.device.type != "cuda" or len(layers) != trainer.model.cfg.num_hidden_layers:
        raise SystemExit(f"flickr_probe.json has {len(layers)} layers (on {trainer.device})")
    if any(launches):
        raise SystemExit(f"the probe launched kernels: {launches}")

    # the whole split's [L, B, H, T, T], collected batch by batch at the
    # probe's batch shape without the repeated tail rows, counted at once
    cfg = parse_task_config(raw)
    tok = registry._tokenizer(cfg)
    ann, feats = flickr.make_synthetic(FLICKR_EXAMPLES, tok, feat_dim=cfg.model.visual_embedding_dim)
    ds = flickr.Flickr30kDataset(ann, feats, tok, max_seq_length=FLICKR_DATA["max_seq_length"],
                                 max_regions=FLICKR_DATA["max_regions"], max_entities=FLICKR_DATA["max_entities"])
    parts, position, label = [], [], []
    for batch in Batcher(ds, bs, shuffle=False, drop_last=False, pad_final=True).epoch(0):
        n = int(batch["_real_count"])
        parts.append(trainer.eval_step(batch, output_attention_probs=True)["attention_weights"][:, :n])
        position.append(batch["flickr_position"][:n])
        label.append(batch["label"][:n])
    whole = torch.cat(parts, dim=1)
    del parts
    position, label = np.concatenate(position), np.concatenate(label)
    era = entity_region_attention(whole, torch.as_tensor(position), FLICKR_DATA["max_seq_length"],
                                  FLICKR_DATA["max_regions"]).cpu().numpy()
    hits, total = grounding_counts_from_era(era, position, label)
    again = [float(h) / total for h in hits]
    log(f"flickr_probe recomputed from one {list(whole.shape)} {str(whole.dtype).replace('torch.', '')} collection "
        f"({whole.numel() * whole.element_size() / 2**30:.2f} GiB): {total} entities, hits "
        + ", ".join(map(str, hits)) + f"; equal to flickr_probe.json: {again == layers and total == probe['entities']}")
    del whole
    torch.cuda.empty_cache()
    if again != layers or total != probe["entities"] or result.best_metric != max(layers):
        raise SystemExit("flickr_probe.json disagrees with the whole-split recomputation")


def run_flickr_phases(torch, card):
    folder = tempfile.mkdtemp(prefix="chip_smoke_flickr_")
    try:
        ckpt = run_flickr_cli(torch, card, folder)
        torch.cuda.empty_cache()
        run_flickr_probe_cli(torch, card, folder, ckpt)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def vcr_attention_inputs(torch):
    """K1/K2's inputs at the VCR step's shapes (128 rows = 32 questions x 4
    choices, T = 128 text + 20 boxes, H = 12, D = 64, bf16): each row's
    text padded after its own length, some rows' last boxes padded, from
    RandomState(1)."""
    import numpy as np

    H, D = 12, 64
    F = 3 * H * D
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    qkv = torch.tensor(rng.randn(VCR_ROWS, VCR_T, F), dtype=torch.bfloat16, device=dev)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=dev)
    mask = np.ones((VCR_ROWS, VCR_T), np.float32)
    for r in range(VCR_ROWS):
        mask[r, rng.randint(24, 129):128] = 0  # the choice's text ends
        if r % 3 == 0:
            mask[r, VCR_T - rng.randint(1, 6):] = 0  # padded boxes
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(VCR_ROWS, VCR_T, H * D), dtype=torch.bfloat16, device=dev)
    return qkv, qb, key_bias, dout


def unsup_attention_inputs(torch, T, text_len, rows=UNSUP_ROWS):
    """K1/K2's inputs at the unsupervised step's shapes (``rows`` rows of T,
    H = 12, D = 64, bf16): each row's first ``text_len`` keys (its text, if
    any) padded after a drawn length, the tags and regions after them real,
    from RandomState(3)."""
    import numpy as np

    H, D = 12, 64
    F = 3 * H * D
    rng = np.random.RandomState(3)
    dev = torch.device("cuda")
    qkv = torch.tensor(rng.randn(rows, T, F), dtype=torch.bfloat16, device=dev)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=dev)
    mask = np.ones((rows, T), np.float32)
    for r in range(rows if text_len else 0):
        mask[r, rng.randint(6, text_len + 1):text_len] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(rows, T, H * D), dtype=torch.bfloat16, device=dev)
    return qkv, qb, key_bias, dout


def mesh_attention_inputs(torch, shape):
    """K1/K2's inputs on the second rank of a two-rank mesh ``shape`` of the
    main path: the main path's inputs (packed_inputs) cut to the rank's
    share, (2, 1) rows 64-127 of 12 heads, (1, 2) the 128 rows' heads 6-11
    (a block of the head-major packing is whole heads)."""
    qkv, qb, key_bias, dout = packed_inputs(torch)
    d, m = shape
    rows = slice(qkv.shape[0] // d * (d - 1), None)
    f, o = qkv.shape[2] // m, dout.shape[2] // m
    return (qkv[rows, :, f * (m - 1):].contiguous(), qb[f * (m - 1):].contiguous(),
            key_bias[rows].contiguous(), dout[rows, :, o * (m - 1):].contiguous())


def check_packed_at(torch, card, where, inputs, H=12):
    """K1/K2 on ``inputs`` (a path's shapes, H heads of 64), dropout 0 and
    0.1, against their plain versions at the main path's limits; timed
    beside scaled_dot_product_attention and their bound."""
    from visualbert_torch.ops import flash_attention as fa

    qkv, qb, key_bias, dout = inputs
    B, T, F = qkv.shape
    D = 64
    for rate in (0.0, 0.1):
        out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 7)
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 7)
        dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 7)
        dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 7)
        torch.cuda.synchronize()
        e_out, r_out = rel_err(out, out_r)
        e_st = float((stats - stats_r).abs().max())
        e_dq, r_dq = rel_err(dqkv, dqkv_r)
        e_db, r_db = rel_err(dqb, dqb_r)
        log(f"K1 at {where} [{B}, {T}, {F}] rate {rate}: out max_abs_err {e_out:.3e} (rel {r_out:.3e}, tol {OUT_TOL}); "
            f"stats max_abs_err {e_st:.3e} (tol {STATS_TOL}); K2: dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, "
            f"tol {DQKV_TOL}); dqkv_bias max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DB_TOL})")
        if not (r_out <= OUT_TOL and e_st <= STATS_TOL and r_dq <= DQKV_TOL and r_db <= DB_TOL):
            raise SystemExit(f"K1/K2 disagree with their plain versions at {where} shape, rate {rate}")
    del out_r, dqkv_r
    rate = 0.1
    k1 = dict(ms=cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 20),
              plain_ms=cuda_time_ms(lambda: fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5), 3))
    k2 = dict(ms=cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 20),
              plain_ms=cuda_time_ms(
                  lambda: fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 3))
    q, k, v = ((qkv + qb).view(B, T, H, 3, D).unbind(3))
    k1["library_ms"], k2["library_ms"] = sdpa_ms(torch, *(t.transpose(1, 2) for t in (q, k, v)), key_bias,
                                                 dout.view(B, T, H, D).transpose(1, 2), rate)
    del q, k, v
    gflop = 2.0 * B * H * T * T * D / 1e9
    k1.update(bound(nbytes(qkv, qb, key_bias, out, stats), 2 * gflop * 1e9, BF16_FLOPS))
    k2.update(bound(nbytes(qkv, qb, key_bias, dout, out, stats, dqkv, dqb), 4 * gflop * 1e9, BF16_FLOPS))
    for name, r in ((f"packed_attention_fwd at {where} [{B}, {T}, {F}]", k1),
                    (f"packed_attention_bwd at {where} [{B}, {T}, {F}]", k2)):
        log(row_line(name, r, card))
    return k1, k2


def run_vcr_step(torch, card):
    """STEPS train steps of the VCR model at configs/vcr_finetune_qa.json's
    full size (tools/vcr_path.py) on one repeated batch; then the detector's
    forward alone."""
    from visualbert_torch.tools import vcr_path

    raw = vcr_path.config()
    log(f"vcr step: model block {json.dumps(raw['model'])}, optimizer {json.dumps(raw['optimizer'])} with schedule "
        f"none, data {json.dumps({k: raw['data'][k] for k in ('max_seq_length', 'max_boxes', 'final_dim', 'cnn_loss_ratio', 'image_size')})}")
    trainer, batch = vcr_path.build(raw=raw)
    B = batch["images"].shape[0]
    log(f"vcr step batch: {B} questions, images {list(batch['images'].shape)} {batch['images'].dtype} (content "
        f"{int(batch['image_hw'].min())}-{int(batch['image_hw'].max())} px), {int(batch['box_mask'].sum())} real boxes "
        f"of {batch['box_mask'].numel()}, text {list(batch['input_ids'].shape)}; "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M parameters in "
        f"{sum(1 for _ in trainer.model.parameters())} tensors")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, cnn, times = [], [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        losses.append(float(metrics["loss"]))
        cnn.append(float(metrics["cnn_regularization_loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[1:])
    log(f"vcr step: losses ({STEPS} steps, one repeated batch): " + ", ".join(f"{x:.5f}" for x in losses)
        + "; cnn_regularization_loss " + ", ".join(f"{x:.5f}" for x in cnn))
    log(f"vcr step: launches over {STEPS} steps: "
        + ", ".join(f"{label} {n} ({n / STEPS:g}/step)" for label, n in zip(LABELS, launches))
        + f"; want {'/'.join(map(str, VCR_TRAIN_PER_STEP))} per step")
    log(f"vcr step: median {med * 1e3:.2f} ms over steps 2..{STEPS} (first step {times[0] * 1e3:.1f} ms), "
        f"{B / med:.2f} images/s ({4 * B / med:.1f} question-choice rows/s), peak memory {peak:.2f} GiB  [{card}]")
    if not all(math.isfinite(x) for x in losses + cnn):
        raise SystemExit("vcr step: non-finite loss")
    if not losses[-1] < losses[0]:
        raise SystemExit("vcr step: the loss did not fall on the repeated batch")
    if launches != [n * STEPS for n in VCR_TRAIN_PER_STEP]:
        raise SystemExit(f"vcr step: unexpected kernel launch counts {launches}")
    det = trainer.model.detector
    keys = ("images", "boxes", "box_mask", "classes", "segms")
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: det(*(batch[k] for k in keys), None, batch["image_hw"]), 5)
    log(f"vcr detector forward alone (no grad, {B} images of {batch['images'].shape[1]} x "
        f"{batch['images'].shape[2]}, {batch['boxes'].shape[1]} boxes each): "
        f"{fwd_ms:.2f} ms  [{card}]")
    del trainer, batch
    return dict(median_ms=med * 1e3, images_per_s=B / med, peak_gib=peak, detector_forward_ms=fwd_ms)


def vcr_cli_raw():
    """configs/vcr_finetune_qa.json with its data block's files swapped for
    VCR_EXAMPLES synthetic questions (32 x 32 images, 3 boxes padded to the
    config's 20), one epoch."""
    from visualbert_torch.tools import vcr_path

    raw = vcr_path.config()
    d = raw["data"]
    raw["data"] = dict({k: d[k] for k in ("max_seq_length", "max_boxes", "final_dim", "cnn_loss_ratio")},
                       synthetic=VCR_EXAMPLES)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    return raw


def run_vcr_cli(torch, card):
    """VCR through the CLI: one epoch, then --eval_only of its checkpoint,
    which must give the epoch's val_ metrics within 1e-6 and the same
    vcr_logits.npy within 1e-5 (equal argmax), one row per eval question."""
    import numpy as np

    raw = vcr_cli_raw()
    n_train = int(VCR_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_batches = -(-(VCR_EXAMPLES - n_train) // raw["train"]["eval_batch_size"])
    folder = tempfile.mkdtemp(prefix="chip_smoke_vcr_")
    try:
        path = write_config(folder, "vcr_synthetic.json", raw)
        run = os.path.join(folder, "run")
        zero_launches()
        t0 = time.perf_counter()
        trainer, result, printed = run_cli_quiet(["--config", path, "--folder", run])
        wall = time.perf_counter() - t0
        launches = read_launches()
        epoch = result.history[0]
        want = [steps * a + 2 * eval_batches * b for a, b in zip(VCR_TRAIN_PER_STEP, VCR_EVAL_PER_BATCH)]
        log(f"vcr cli: {printed}; {trainer.step} steps at batch {raw['train']['train_batch_size']} on "
            f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
        log("vcr cli launches: " + launch_text(launches)
            + f"; want {steps} x {'/'.join(map(str, VCR_TRAIN_PER_STEP))} (train steps) + 2 x {eval_batches} x "
            + f"{'/'.join(map(str, VCR_EVAL_PER_BATCH))} (eval batches)")
        if trainer.device.type != "cuda" or trainer.step != steps:
            raise SystemExit(f"the vcr CLI ran {trainer.step} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite metric in the vcr CLI run")
        if launches != want:
            raise SystemExit(f"unexpected kernel launch counts in the vcr CLI run {launches}")
        logits = np.load(os.path.join(run, "vcr_logits.npy"))
        if logits.shape != (VCR_EXAMPLES - n_train, 4) or not np.isfinite(logits).all():
            raise SystemExit(f"vcr_logits.npy holds {logits.shape}, not one finite row of 4 per eval question")
        del trainer, result
        torch.cuda.empty_cache()

        again = os.path.join(folder, "eval")
        zero_launches()
        _, result, printed = run_cli_quiet(["--config", path, "--folder", again, "--eval_only",
                                            "--restore", os.path.join(run, "ckpt")])
        launches = read_launches()
        metrics = result.history[0]
        diff = max(abs(metrics[k] - epoch["val_" + k]) for k in ("loss", "accuracy", "cnn_regularization_loss"))
        logits2 = np.load(os.path.join(again, "vcr_logits.npy"))
        l_diff = float(np.abs(logits2 - logits).max()) if logits2.shape == logits.shape else float("inf")
        same_argmax = logits2.shape == logits.shape and (logits2.argmax(-1) == logits.argmax(-1)).all()
        log(f"vcr --eval_only: {printed}; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            + f"; max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6); vcr_logits.npy {list(logits2.shape)}, "
            f"max |diff| {l_diff:.2e} (tol 1e-5), argmax equal: {bool(same_argmax)}; launches " + launch_text(launches))
        if diff > 1e-6 or l_diff > 1e-5 or not same_argmax:
            raise SystemExit("--eval_only does not reproduce the vcr run's evaluation")
        if launches != [eval_batches * b for b in VCR_EVAL_PER_BATCH]:
            raise SystemExit(f"unexpected kernel launch counts in the vcr --eval_only run {launches}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_vcr_coco_cli(torch, card):
    """vcr_coco_pretrain through the CLI: configs/coco_pretrain.json's model,
    optimizer and train blocks with "task": "vcr_coco_pretrain" and
    VCR_COCO_EXAMPLES synthetic captioned images (32 x 32, 3 boxes and the
    window row, padded to 20), one epoch."""
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.utils.config_io import load_config_file, parse_task_config

    raw = load_config_file(CONFIG)
    raw["task"] = "vcr_coco_pretrain"
    raw["data"] = {"synthetic": VCR_COCO_EXAMPLES, "max_seq_length": 128, "max_boxes": 20, "two_sentence": True}
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    train = parse_task_config(raw).train
    n_train = int(VCR_COCO_EXAMPLES * 0.8)
    steps = n_train // train.train_batch_size
    eval_batches = -(-(VCR_COCO_EXAMPLES - n_train) // train.eval_batch_size)
    folder = tempfile.mkdtemp(prefix="chip_smoke_vcr_coco_")
    try:
        path = write_config(folder, "vcr_coco_synthetic.json", raw)
        zero_launches()
        t0 = time.perf_counter()
        trainer, result, printed = run_cli_quiet(["--config", path, "--folder", os.path.join(folder, "run")])
        wall = time.perf_counter() - t0
        launches = read_launches()
        epoch = result.history[0]
        want = [steps * a + eval_batches * b for a, b in zip(VCR_COCO_TRAIN_PER_STEP, VCR_COCO_EVAL_PER_BATCH)]
        log(f"vcr_coco_pretrain cli: {printed}; {trainer.step} steps at batch {train.train_batch_size} on "
            f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(epoch.items())))
        log("vcr_coco_pretrain cli launches: " + launch_text(launches)
            + f"; want {steps} x {'/'.join(map(str, VCR_COCO_TRAIN_PER_STEP))} (train steps) + {eval_batches} x "
            + f"{'/'.join(map(str, VCR_COCO_EVAL_PER_BATCH))} (eval batches)")
        if trainer.device.type != "cuda" or trainer.step != steps:
            raise SystemExit(f"the vcr_coco_pretrain CLI ran {trainer.step} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite metric in the vcr_coco_pretrain CLI run")
        if launches != want:
            raise SystemExit(f"unexpected kernel launch counts in the vcr_coco_pretrain CLI run {launches}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def unsup_xent_labels():
    """The MLM labels of the unsupervised step's two batches, one row a
    text token: (V&L [144 x 30], text-only [144 x 64]), flattened."""
    from visualbert_torch.tools import unsup_path

    raw = unsup_path.config()
    vl, text = unsup_path.synth_batches(UNSUP_ROWS, int(raw["data"]["max_seq_length"]), int(raw["data"]["n_regions"]))
    return vl["masked_lm_labels"].reshape(-1), text["masked_lm_labels"].reshape(-1)


def run_unsup_step(torch, card):
    """UNSUP_STEPS train steps of the unsupervised model at configs/
    unsup_pretrain.json's full width (tools/unsup_path.py), its V&L,
    text-only and image-only batches in turn; each step's launches are read
    on their own."""
    from visualbert_torch.tools import unsup_path

    raw = unsup_path.config()
    log(f"unsup step: model block {json.dumps(raw['model'])}, optimizer {json.dumps(raw['optimizer'])} with "
        f"schedule none, data {json.dumps({k: raw['data'][k] for k in ('max_seq_length', 'n_regions')})}")
    trainer, batches = unsup_path.build(raw=raw)
    shapes = {k: {n: list(v.shape) for n, v in b.items() if n in ("input_ids", "visual_tags", "visual_feats")}
              for k, b in batches.items()}
    log(f"unsup step batches: {json.dumps(shapes)}; "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M parameters in "
        f"{sum(1 for _ in trainer.model.parameters())} tensors")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, bad = {k: [] for k in batches}, {k: [] for k in batches}, []
    want = {"vl": UNSUP_PER_STEP, "text": UNSUP_PER_STEP, "image": UNSUP_IMAGE_PER_STEP}
    for i in range(UNSUP_STEPS):
        source = ("vl", "text", "image")[i % 3]
        zero_launches()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batches[source])
        losses[source].append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times[source].append(time.perf_counter() - t0)
        launches = read_launches()
        if launches != list(want[source]):
            bad.append((i, source, launches))
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {}
    for source in batches:
        B = len(batches[source]["visual_tags" if source == "image" else "input_ids"])
        med = statistics.median(times[source][1:])
        out[source] = dict(median_ms=med * 1e3, pairs_per_s=B / med)
        log(f"unsup step, {source} batch: losses " + ", ".join(f"{x:.5f}" for x in losses[source])
            + f"; median {med * 1e3:.2f} ms over its steps 2..{len(times[source])} (first "
              f"{times[source][0] * 1e3:.1f} ms), {B / med:.1f} pairs/s  [{card}]")
    log(f"unsup step: launches of every V&L and text-only step {'/'.join(map(str, UNSUP_PER_STEP))}, of every "
        f"image-only step {'/'.join(map(str, UNSUP_IMAGE_PER_STEP))} (K1..K16, site fwd/bwd) wanted; steps that "
        f"differ: {bad}; peak memory {peak:.2f} GiB  [{card}]")
    for source, ls in losses.items():
        if not all(math.isfinite(x) for x in ls):
            raise SystemExit(f"unsup step: non-finite loss on the {source} batch")
        if not ls[-1] < ls[0]:
            raise SystemExit(f"unsup step: the loss did not fall on the repeated {source} batch")
    if bad:
        raise SystemExit(f"unsup step: unexpected kernel launch counts {bad}")
    del trainer, batches
    return dict(out, peak_gib=peak)


def e2e_xent_labels():
    """The MLM labels of the end-to-end step's batch, one row a text token
    ([32 x 30], flattened)."""
    from visualbert_torch.tools import unsup_e2e_path

    raw = unsup_e2e_path.config()
    host = unsup_e2e_path.synth_batch(E2E_ROWS, unsup_e2e_path.IMAGE_SIZE, UNSUP_N, int(raw["data"]["max_seq_length"]))
    return host["masked_lm_labels"].reshape(-1)


def run_e2e_step(torch, card):
    """STEPS train steps of the end-to-end unsupervised model
    (tools/unsup_e2e_path.py: the full ResNet50 detector in the graph,
    configs/unsup_pretrain.json's model block, E2E_ROWS uint8 768 x 768
    images of 36 boxes) on one repeated batch through Trainer.train_step."""
    from visualbert_torch.tools import unsup_e2e_path

    raw = unsup_e2e_path.config()
    log(f"e2e step: model block {json.dumps(raw['model'])}, optimizer {json.dumps(raw['optimizer'])} with schedule "
        f"none, data {json.dumps({k: raw['data'][k] for k in ('max_seq_length', 'n_regions')})}; the ResNet50 "
        f"detector (7 x 7 stem, layers (3, 4, 6), layer4 of 3 blocks); batch {unsup_e2e_path.BATCH} "
        f"(the config's {raw['train']['train_batch_size']} cut to fit the detector on one card)")
    trainer, batch = unsup_e2e_path.build(raw=raw)
    B = batch["images"].shape[0]
    log(f"e2e step batch: images {list(batch['images'].shape)} {batch['images'].dtype}, boxes "
        f"{list(batch['boxes'].shape)}, text {list(batch['input_ids'].shape)}, "
        f"{int((batch['masked_lm_labels'] >= 0).sum())} MLM labels, {int(batch['feat_mask'].sum())} masked "
        f"regions and tags; {sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M parameters in "
        f"{sum(1 for _ in trainer.model.parameters())} tensors")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = ("loss", "masked_lm_loss", "matched_loss", "obj_loss", "feat_loss", "masked_tag_loss")
    losses, times, bad = {k: [] for k in keys}, [], []
    det = trainer.model.detector
    conv1_grad, feat_scale = [], []
    for i in range(STEPS):
        zero_launches()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        for k in keys:
            if k not in metrics:
                raise SystemExit(f"e2e step: {k} missing from the step's outputs {sorted(metrics)}")
            losses[k].append(float(metrics[k]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = read_launches()
        if launches != list(E2E_PER_STEP):
            bad.append((i, launches))
        conv1_grad.append(float(det.conv1.weight.grad.abs().sum()) if det.conv1.weight.grad is not None else 0.0)
        with torch.no_grad():  # the scale of the features, after the update: feat_loss's target
            feat_scale.append(float(det(batch["images"], batch["boxes"], batch["box_mask"])["obj_reps_raw"]
                                    .float().abs().mean()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[1:])
    for k in keys:
        log(f"e2e step {k}: " + ", ".join(f"{x:.5f}" for x in losses[k]))
    log(f"e2e step: |grad| of the detector's first convolution summed: "
        + ", ".join(f"{x:.4e}" for x in conv1_grad))
    log(f"e2e step: mean |feature| of the detector after each update (feat_loss's target): "
        + ", ".join(f"{x:.4f}" for x in feat_scale))
    log(f"e2e step: launches of every step {'/'.join(map(str, E2E_PER_STEP))} (K1..K16, site fwd/bwd) wanted; "
        f"steps that differ: {bad}")
    log(f"e2e step: median {med * 1e3:.2f} ms over steps 2..{STEPS} (first step {times[0] * 1e3:.1f} ms), "
        f"{B / med:.2f} images/s, peak memory {peak:.2f} GiB (batch {B}, cut from 144)  [{card}]")
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise SystemExit("e2e step: non-finite loss")
    # the objectives whose targets are the batch's or the detector's classes
    # must fall; feat_loss regresses the detector's own features, whose scale
    # the end-to-end updates move (it rises with it, in JAX as here)
    falling = ("masked_lm_loss", "matched_loss", "obj_loss", "masked_tag_loss")
    if not all(losses[k][-1] < losses[k][0] for k in falling):
        raise SystemExit(f"e2e step: {[k for k in falling if not losses[k][-1] < losses[k][0]]} did not fall on the "
                         f"repeated batch")
    if not all(g > 0 for g in conv1_grad):
        raise SystemExit("e2e step: the detector's first convolution got no gradient")
    if bad:
        raise SystemExit(f"e2e step: unexpected kernel launch counts {bad}")
    del trainer, batch
    return dict(median_ms=med * 1e3, images_per_s=B / med, peak_gib=peak,
                loss=(losses["loss"][0], losses["loss"][-1]), feat_scale=(feat_scale[0], feat_scale[-1]))


def run_th_restore_cli(torch, card):
    """A reference torch checkpoint through the CLI: a VQA run (configs/
    vqa_finetune.json with the fused LayerNorm, TH_EXAMPLES synthetic
    questions, one epoch) whose parameters are saved in the reference
    layout (a DataParallel ``module.`` prefix, LayerNorm ``gamma``/``beta``)
    as a .th file; ``--eval_only --restore`` of that file must load every
    parameter equal to its source and reproduce the epoch's val_ metrics."""
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(VQA_CONFIG)
    raw["data"] = {"synthetic": TH_EXAMPLES, "max_seq_length": 128, "max_regions": 100}
    raw["model"] = dict(raw["model"], use_fused_layer_norm=True)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    n_train = int(TH_EXAMPLES * 0.8)
    steps = n_train // raw["train"]["train_batch_size"]
    eval_batches = -(-(TH_EXAMPLES - n_train) // raw["train"]["eval_batch_size"])
    folder = tempfile.mkdtemp(prefix="chip_smoke_th_")
    try:
        path = write_config(folder, "vqa_synthetic.json", raw)
        trainer, result = run_counted_cli(
            "vqa cli for the .th restore", ["--config", path, "--folder", os.path.join(folder, "run")],
            counts((steps, VQA_TRAIN_PER_STEP), (2 * eval_batches, VQA_EVAL_PER_BATCH)), steps)
        epoch = result.history[0]
        source = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        ref = {"module." + k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"):
               v for k, v in source.items()}
        th = os.path.join(folder, "reference.th")
        torch.save(ref, th)
        del trainer, result
        torch.cuda.empty_cache()
        restored, again = run_counted_cli(
            "vqa --eval_only --restore reference.th",
            ["--config", path, "--folder", os.path.join(folder, "eval"), "--eval_only", "--restore", th],
            counts((eval_batches, VQA_EVAL_PER_BATCH)), None)
        got = restored.model.state_dict()
        unequal = [k for k, v in source.items() if not torch.equal(got[k].cpu(), v)]
        diff = max(abs(again.history[0][k] - epoch["val_" + k]) for k in ("loss", "accuracy"))
        log(f".th restore: {len(ref)} reference-layout tensors ({os.path.getsize(th) / 2**20:.1f} MiB); "
            f"{len(source) - len(unequal)} of {len(source)} parameters equal to their source, on "
            f"{restored.device}; max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6)")
        if unequal or diff > 1e-6 or restored.device.type != "cuda":
            raise SystemExit(f"the .th restore did not reproduce the run: parameters differ {unequal[:5]}, "
                             f"metrics |diff| {diff:.2e}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_tokenizer_check(card):
    """The native WordPiece tokenizer (csrc/wordpiece.cpp), built with g++
    into visualbert_torch/_build/ here, against the Python tokenizer on
    TOKENIZER_TEXTS (non-ASCII ones go to the Python path), one string at a
    time and batched; then both timed on 20,000 ASCII strings."""
    from visualbert_torch.data import fast_tokenizer
    from visualbert_torch.data.tokenization import BertTokenizer

    vocab = {w: i for i, w in enumerate(TOKENIZER_VOCAB)}
    built = fast_tokenizer.library_path().exists()
    t0 = time.perf_counter()
    fast = fast_tokenizer.FastBertTokenizer(vocab)
    ready = time.perf_counter() - t0
    plain = BertTokenizer(vocab)
    bad = [t for t in TOKENIZER_TEXTS if fast.encode(t) != plain.encode(t) or fast.tokenize(t) != plain.tokenize(t)]
    out, lens = fast.encode_batch(TOKENIZER_TEXTS, 16)
    bad += [t for i, t in enumerate(TOKENIZER_TEXTS) if list(out[i, :lens[i]]) != plain.encode(t)[:16]]
    texts = ["the quick brown fox jumps over the lazy dog"] * 20000
    t0 = time.perf_counter()
    fast.encode_batch(texts, 16)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in texts:
        plain.encode(t)
    plain_s = time.perf_counter() - t0
    log(f"native tokenizer: {fast_tokenizer.library_path().relative_to(REPO)} "
        f"{'already built' if built else 'built by g++'}, ready after {ready:.2f} s; native path on: "
        f"{fast.native_available}; {len(TOKENIZER_TEXTS)} strings ({sum(not t.isascii() for t in TOKENIZER_TEXTS)} "
        f"non-ASCII) equal to the Python tokenizer's, one at a time and batched: {not bad}; 20,000 strings in "
        f"{fast_s * 1e3:.1f} ms batched against {plain_s * 1e3:.1f} ms in Python (host)")
    if bad or not fast.native_available:
        raise SystemExit(f"the native tokenizer differs from the Python one on {bad}")


def run_process_batches(card):
    """The Batcher's process workers against its thread workers on the COCO
    synthetic set of phase 7 (CLI_EXAMPLES pairs, 128 tokens + 100 regions
    of 2048-d features, batch 128, 4 workers): two epochs, every batch bit
    for bit, each process-mode batch held until the end."""
    from visualbert_torch.data.datasets import coco
    from visualbert_torch.data.pipeline import Batcher
    from visualbert_torch.tasks.registry import _tokenizer
    from visualbert_torch.utils.config_io import parse_task_config

    tok = _tokenizer(parse_task_config({"task": "coco_pretrain", "data": {"synthetic": CLI_EXAMPLES}}))
    ann, feats = coco.make_synthetic(CLI_EXAMPLES, tok, feat_dim=2048)
    ds = coco.CocoCaptionsDataset(ann, feats, tok, max_seq_length=128, max_regions=100)
    thread = Batcher(ds, 128, seed=0, num_workers=4)
    proc = Batcher(ds, 128, seed=0, num_workers=4, worker_mode="process")
    bad, n, walls = [], 0, {"thread": 0.0, "process": 0.0}
    try:
        for epoch in (0, 1):
            t0 = time.perf_counter()
            held = list(proc.epoch(epoch))
            walls["process"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = list(thread.epoch(epoch))
            walls["thread"] += time.perf_counter() - t0
            if len(held) != len(want):
                bad.append((epoch, "batch count"))
            for i, (a, b) in enumerate(zip(want, held)):
                n += 1
                if set(a) != set(b) or any(a[k].tobytes() != b[k].tobytes() or a[k].dtype != b[k].dtype for k in a):
                    bad.append((epoch, i))
    finally:
        thread.close()
        proc.close()
    log(f"process workers: {n} batches of 128 over two epochs equal to the thread workers' bit for bit: {not bad}; "
        f"host wall {walls['process']:.2f} s (process) against {walls['thread']:.2f} s (thread), 4 workers each")
    if bad or n == 0:
        raise SystemExit(f"process-mode batches differ from thread-mode batches: {bad}")


def run_counted_cli(name, argv, want, steps):
    """train_cli on ``argv`` with the launch counts set to 0 first; the
    run must be on the card, take ``steps`` steps, give finite metrics and
    launch ``want``. Returns (trainer, result)."""
    zero_launches()
    t0 = time.perf_counter()
    trainer, result, printed = run_cli_quiet(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    metrics = result.history[0]
    log(f"{name}: {printed}; {trainer.step} steps on {trainer.device}, {wall:.1f} s with set-up; "
        + ", ".join(f"{k} {v:.6f}" for k, v in sorted(metrics.items())))
    log(f"{name} launches: {launch_text(launches)}; want {launch_text(want)}")
    if trainer.device.type != "cuda" or (steps is not None and trainer.step != steps):
        raise SystemExit(f"{name} ran {trainer.step} steps on {trainer.device}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"non-finite metric in the {name} run")
    if launches != list(want):
        raise SystemExit(f"unexpected kernel launch counts in the {name} run {launches}")
    return trainer, result


def counts(*terms):
    """The launches of (n, per-step counts) terms, summed."""
    return [sum(n * c[i] for n, c in terms) for i in range(len(LABELS))]


def run_unsup_cli(torch, card):
    """unsup_pretrain through the CLI: configs/unsup_pretrain.json with a
    synthetic data block, a PackedCorpus built and saved here as its
    text_corpus, a val split, one epoch."""
    from visualbert_torch.data.text_corpus import PackedCorpus
    from visualbert_torch.tasks.registry import _tokenizer
    from visualbert_torch.tools import unsup_path
    from visualbert_torch.utils.config_io import parse_task_config

    raw = unsup_path.config()
    d = raw["data"]
    raw["data"] = dict({k: d[k] for k in ("max_seq_length", "n_regions", "matched_prob", "text_ratio")},
                       synthetic=UNSUP_EXAMPLES, val_synthetic=UNSUP_VAL)
    raw["train"] = dict(raw["train"], num_train_epochs=1, eval_batch_size=raw["train"]["train_batch_size"])
    cfg = parse_task_config(raw)
    B = cfg.train.train_batch_size
    folder = tempfile.mkdtemp(prefix="chip_smoke_unsup_")
    try:
        tok = _tokenizer(cfg)
        words = [w for w in tok.vocab if not w.startswith("[")]
        passages = [[" ".join(words[(7 * i + j) % len(words)] for j in range(k, k + 12)) for k in range(0, 60, 12)]
                    for i in range(UNSUP_PASSAGES)]
        raw["data"]["text_corpus"] = os.path.join(folder, "corpus.npz")
        PackedCorpus.build(passages, tok).save(raw["data"]["text_corpus"])
        path = write_config(folder, "unsup_synthetic.json", raw)
        vl_steps, text_steps = UNSUP_EXAMPLES // B, UNSUP_PASSAGES // B
        want = counts((vl_steps + text_steps, UNSUP_PER_STEP), (UNSUP_VAL // B, UNSUP_EVAL_PER_BATCH))
        _, result = run_counted_cli("unsup_pretrain cli", ["--config", path, "--folder", os.path.join(folder, "run")],
                                    want, vl_steps + text_steps)
        keys = {"train_masked_lm_loss", "train_matched_loss", "train_obj_loss", "train_masked_tag_loss", "val_loss"}
        if not keys <= set(result.history[0]):
            raise SystemExit(f"the unsup_pretrain CLI run lacks {sorted(keys - set(result.history[0]))}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_text_pretrain_cli(torch, card):
    """text_pretrain through the CLI: configs/coco_pretrain.json's model,
    optimizer and train blocks, a synthetic corpus, one epoch."""
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.utils.config_io import load_config_file, parse_task_config

    raw = load_config_file(CONFIG)
    raw["task"] = "text_pretrain"
    raw["data"] = {"synthetic": TEXT_PRETRAIN_EXAMPLES, "max_seq_length": 64}
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    steps = TEXT_PRETRAIN_EXAMPLES // parse_task_config(raw).train.train_batch_size
    folder = tempfile.mkdtemp(prefix="chip_smoke_text_")
    try:
        path = write_config(folder, "text_synthetic.json", raw)
        run_counted_cli("text_pretrain cli", ["--config", path, "--folder", os.path.join(folder, "run")],
                        counts((steps, TEXT_PRETRAIN_PER_STEP)), steps)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_unsup_vqa_cli(torch, card):
    """unsup_vqa through the CLI with configs/unsup_pretrain.json's model
    block on a synthetic set, one epoch; then --eval_only of its
    checkpoint, which must give the epoch's val_ metrics within 1e-6."""
    from visualbert_torch.tools import unsup_path

    shipped = unsup_path.config()
    B = shipped["train"]["train_batch_size"]
    raw = {"task": "unsup_vqa", "model": shipped["model"], "optimizer": shipped["optimizer"],
           "data": {"synthetic": UNSUP_VQA_EXAMPLES, "n_regions": UNSUP_N, "max_seq_length": 20},
           "train": {"train_batch_size": B, "eval_batch_size": B, "num_train_epochs": 1}}
    n_train = int(UNSUP_VQA_EXAMPLES * 0.8)
    steps, eval_batches = n_train // B, -(-(UNSUP_VQA_EXAMPLES - n_train) // B)
    folder = tempfile.mkdtemp(prefix="chip_smoke_unsup_vqa_")
    try:
        path = write_config(folder, "unsup_vqa_synthetic.json", raw)
        run = os.path.join(folder, "run")
        _, result = run_counted_cli("unsup_vqa cli", ["--config", path, "--folder", run],
                                    counts((steps, UNSUP_VQA_TRAIN_PER_STEP),
                                           (eval_batches, UNSUP_VQA_EVAL_PER_BATCH)), steps)
        epoch = result.history[0]
        torch.cuda.empty_cache()
        _, again = run_counted_cli("unsup_vqa --eval_only",
                                   ["--config", path, "--folder", os.path.join(folder, "eval"), "--eval_only",
                                    "--restore", os.path.join(run, "ckpt")],
                                   counts((eval_batches, UNSUP_VQA_EVAL_PER_BATCH)), None)
        diff = max(abs(again.history[0][k] - epoch["val_" + k]) for k in ("loss", "accuracy"))
        log(f"unsup_vqa --eval_only: max |diff| to the epoch's val_ metrics {diff:.2e} (tol 1e-6)")
        if diff > 1e-6:
            raise SystemExit("--eval_only does not reproduce the unsup_vqa run's evaluation")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def update_gaps(start, want, got):
    """||u_got - u_want|| / ||u_want|| of each parameter tensor, u = final -
    start (for a tensor the one-process step left unchanged, the frozen
    pooler, the largest |u_got|), largest first. The key biases are left
    out: their gradient is zero but for rounding (softmax is
    shift-invariant), so BertAdam steps them by noise on either side."""
    gaps = []
    for k, w in want.items():
        if k.endswith("attention.self.key.bias"):
            continue
        u_want, u_got = w - start[k], got[k] - start[k]
        norm = float(u_want.norm())
        gaps.append((float((u_got - u_want).norm()) / norm if norm > 0 else float(u_got.abs().max()), k))
    return sorted(gaps, reverse=True)


def mesh_rank_lines(what, res, per_step, steps, card):
    """Log each rank's numbers; raise unless every rank launched ``per_step``
    a step."""
    for r in res:
        heads, fwd, bwd = r["attention"]
        got = {k: n / steps for k, n in r["launches"].items()}
        log(f"{what} rank {r['index']}: {r['rows']} rows, launches a step "
            + ", ".join(f"{k} {v:g}" for k, v in got.items())
            + f"; K1 {fwd:.4f} ms, K2 {bwd:.4f} ms on {heads} heads x {r['rows']} rows (rate 0.1); median step "
            f"{r['median_ms']:.1f} ms (both ranks on the card, gloo through the host), peak memory "
            f"{r['peak_gib']:.2f} GiB  [{card}]")
        coll = r["collectives"]
        log(f"{what} rank {r['index']}: collectives a step (host clock, the card synchronized before and after "
            f"each, a peer's wait included) " + ", ".join(
                f"{k} {c['calls']:g} calls {c['ms']:.1f} ms {c['bytes'] / 1e6:.1f} MB" for k, c in coll.items())
            + f"; {sum(c['ms'] for c in coll.values()):.1f} of the mean step's {statistics.mean(r['step_ms']):.1f} "
            f"ms  [{card}]")
        if got != per_step:
            raise SystemExit(f"{what} rank {r['index']}: launches a step {got}, want {per_step}")


def run_mesh_path(torch, card):
    """Phase 25 (a): the main path on meshes (2, 1) and (1, 2) of two gloo
    ranks sharing the card against one process, then dropout on (1, 2)."""
    from visualbert_torch.tools import mesh_path
    from visualbert_torch.tools.main_path import build, model_block

    block = dict(model_block(), use_fused_layer_norm=True)
    still = dict(block, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    trainer, batch = build(still)
    start = {k: p.detach().float().cpu() for k, p in trainer.model.named_parameters()}
    want_losses = [float(trainer.train_step(batch)["loss"]) for _ in range(MESH_STEPS)]
    want = {k: p.detach().float().cpu() for k, p in trainer.model.named_parameters()}
    del trainer, batch
    torch.cuda.empty_cache()
    log("mesh: one process, dropout 0, losses " + ", ".join(f"{x:.6f}" for x in want_losses))
    folder = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        for shape in ((2, 1), (1, 2)):
            what = f"mesh {shape}"
            t0 = time.perf_counter()
            res = mesh_path.launch(dict(block=still, mesh=shape, steps=MESH_STEPS, gather=True), 2,
                                   os.path.join(folder, f"{shape[0]}x{shape[1]}"))
            wall = time.perf_counter() - t0
            losses = res[0]["losses"]
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
            gaps = update_gaps(start, want, res[0]["params"])
            gap = gaps[0][0]
            log(f"{what}: two gloo ranks, {wall:.1f} s with start-up; losses " + ", ".join(f"{x:.6f}" for x in losses)
                + f", max rel diff to one process {loss_gap:.2e} (tol {MESH_LOSS_TOL}); parameter update gaps "
                + ", ".join(f"{g:.3e} ({k})" for g, k in gaps[:3]) + f", median {gaps[len(gaps) // 2][0]:.3e} over "
                f"{len(gaps)} tensors (tol {MESH_UPDATE_TOL})")
            mesh_rank_lines(what, res, MESH_PER_STEP, MESH_STEPS, card)
            if any(r["losses"] != losses for r in res):
                raise SystemExit(f"{what}: the ranks report different losses")
            if not loss_gap <= MESH_LOSS_TOL or not gap <= MESH_UPDATE_TOL:
                raise SystemExit(f"{what}: the mesh's steps differ from the one-process steps")
            del res
        res = mesh_path.launch(dict(block=block, mesh=(1, 2), steps=MESH_DROPOUT_STEPS, replicas=True), 2,
                               os.path.join(folder, "dropout"))
        a, b = (r["replicas"] for r in res)
        apart = {k: float((v.float() - b[k].float()).abs().max()) for k, v in a.items() if not torch.equal(v, b[k])}
        log(f"mesh (1, 2), dropout 0.1, {MESH_DROPOUT_STEPS} steps: losses "
            + ", ".join(f"{x:.5f}" for x in res[0]["losses"])
            + f"; {len(a) - len(apart)} of {len(a)} whole-held parameters bit-equal on both ranks"
            + "".join(f"; {k} apart by up to {d:.3e}" for k, d in apart.items()))
        equal = len(a) - len(apart)
        # the gradients before the broadcast that makes the parameters equal
        worst = []
        for i, step in enumerate(res[1]["grad_gaps"]):
            off = sorted(((g, k) for k, g in step.items() if g > 0), reverse=True)
            worst.append(off[0][0] if off else 0.0)
            log(f"mesh (1, 2) with dropout, step {i + 1}: whole-held gradients on model rank 1 against rank 0 "
                f"before the broadcast: {len(step) - len(off)} of {len(step)} bit-equal"
                + "".join(f"; {k} {g:.3e}" for g, k in off[:4]) + f" (tol {MESH_GRAD_GAP_TOL})")
        mesh_rank_lines("mesh (1, 2) with dropout", res, MESH_DROPOUT_PER_STEP, MESH_DROPOUT_STEPS, card)
        if set(a) != set(b) or equal != len(a) or not all(math.isfinite(x) for x in res[0]["losses"]):
            raise SystemExit("mesh (1, 2) with dropout: the replicas drifted apart")
        if len(worst) != MESH_DROPOUT_STEPS or not max(worst) <= MESH_GRAD_GAP_TOL:
            raise SystemExit("mesh (1, 2) with dropout: the model peers' whole-held gradients differ (their "
                             "hidden-state dropout masks?)")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_torchrun_cli(torch, card):
    """Phase 25 (b): one NCCL rank through torchrun and the training CLI on
    phase 7's COCO synthetic config with "mesh_shape": [1, 1]; its
    checkpoint must load back."""
    import subprocess

    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.train.trainer import Trainer
    from visualbert_torch.utils.checkpoint import CheckpointManager
    from visualbert_torch.utils.config_io import load_config_file, load_task_config

    raw = load_config_file(CONFIG)
    d = raw["data"]
    raw["data"] = dict({k: d[k] for k in ("max_seq_length", "max_regions", "two_sentence")}, synthetic=CLI_EXAMPLES)
    raw["train"] = dict(raw["train"], num_train_epochs=1, mesh_shape=[1, 1])
    folder = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    try:
        path = write_config(folder, "coco_mesh.json", raw)
        run = os.path.join(folder, "run")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
               "-m", "visualbert_torch.train_cli", "--config", path, "--folder", run]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        up = [line for line in proc.stderr.splitlines() if "torch.distributed up" in line]
        printed = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        log(f"torchrun cli: exit {proc.returncode}, {wall:.1f} s; {up[-1].split(': ', 1)[-1] if up else 'no init line'}"
            f"; {printed}")
        if proc.returncode != 0 or not up or "backend nccl" not in up[-1]:
            raise SystemExit("torchrun cli failed:\n" + proc.stderr[-4000:])
        summary = json.loads(printed)
        cfg = load_task_config(path)
        fresh = Trainer(VisualBertForTask(cfg.model, "pretraining"), cfg.optimizer, cfg.train,
                        device="cuda").init_state()
        ckpt = CheckpointManager(os.path.join(run, "ckpt"))
        ckpt.restore(fresh)
        steps = CLI_EXAMPLES // cfg.train.train_batch_size
        finite = all(bool(torch.isfinite(p).all()) for p in fresh.model.parameters())
        log(f"torchrun cli checkpoint {os.path.basename(ckpt.path())}: loaded strict, step {fresh.step}, "
            f"optimizer step {fresh.optimizer.step_count}, parameters finite {finite}")
        if summary["epochs_run"] != 1 or fresh.step != steps or fresh.optimizer.step_count != steps or not finite:
            raise SystemExit("the torchrun CLI run's checkpoint does not load back")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    sys.path.insert(0, REPO)
    from visualbert_torch.ops import _build
    from visualbert_torch.tools.main_path import card_line, model_block

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels: {lib.path.name} from {len(_build.sources())} sources, "
        f"{'built by nvcc in %.1f s' % lib.build_seconds if lib.build_seconds else 'already built'}, "
        f"ready after {time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  ptxas: " + line.strip())

    rows = check_dropout(torch, card)
    rows.update(check_kernels(torch, card))
    check_packed_at(torch, card, "VCR's", vcr_attention_inputs(torch))
    check_packed_at(torch, card, "the unsupervised V&L", unsup_attention_inputs(torch, UNSUP_VL_T, UNSUP_TT))
    check_packed_at(torch, card, "the unsupervised text-only", unsup_attention_inputs(torch, UNSUP_TEXT_T,
                                                                                        UNSUP_TEXT_T))
    check_packed_at(torch, card, "the unsupervised image-only", unsup_attention_inputs(torch, UNSUP_IMAGE_T, 0))
    check_packed_at(torch, card, "the end-to-end", unsup_attention_inputs(torch, UNSUP_VL_T, UNSUP_TT, E2E_ROWS))
    for shape in ((2, 1), (1, 2)):
        check_packed_at(torch, card, f"a mesh {shape} rank's", mesh_attention_inputs(torch, shape), H=12 // shape[1])
    torch.cuda.empty_cache()
    rows.update(check_xent(torch, card))
    check_xent(torch, card, N=MESH_XENT_ROWS)
    check_xent(torch, card, H=1024)
    check_xent(torch, card, N=VQA_ADVANCED_XENT_ROWS)
    for labels in unsup_xent_labels() + (e2e_xent_labels(),):
        check_xent(torch, card, labels=labels)
    torch.cuda.empty_cache()
    attention_rows, attention_form_rows = check_attention_forms(torch, card, rows["packed_attention_bwd"]["ms"])
    rows.update(attention_rows)
    xent_rows, xent_form_rows = check_xent_forms(torch, card)
    rows.update(xent_rows)
    t_forms = time.perf_counter()
    check_f32_masks(torch, card)
    form_rows = check_variant_forms(torch, card)
    form_rows.update(xent_form_rows)
    form_rows.update(attention_form_rows)
    torch.cuda.empty_cache()
    form_rows.update(check_layer_norm_forms(torch, card))
    torch.cuda.empty_cache()
    log(f"phase 3, K11-K14 and K7-K10 in their other forms: {time.perf_counter() - t_forms:.1f} s  [{card}]")
    rows.update(check_layer_norm(torch, card))
    rows.update(check_attention_variants(torch, card))
    save_probs_at_nlvr2_shape(torch, card)
    torch.cuda.empty_cache()
    rows.update(check_attention_experiments(torch, card))
    k16_twin(torch, rows, card)
    torch.cuda.empty_cache()
    exp_launches = run_attention_tools(torch, card)
    torch.cuda.empty_cache()
    mask_launches = run_dropout_tool(torch, card)
    torch.cuda.empty_cache()

    block = model_block()
    fused = dict(block, use_fused_layer_norm=True)
    log(f"model block: {json.dumps(block)}")
    check_slice_reference(torch, block)
    check_slice_reference(torch, dict(block, dtype="float32"), "bert-base fp32", SLICE_F32_REL_TOL)
    check_slice_reference(torch, dict(block, dtype="float16"), "bert-base fp16")
    check_slice_reference(torch, dict(block, **GEOMETRIES[2][1]), "BERT-Small bf16")
    runs = {}
    for what, blk, per_step in (("as shipped", block, PER_STEP),
                                ("fused LayerNorm", fused, FUSED_PER_STEP),
                                ("fused LayerNorm, packed_qkv false", dict(fused, packed_qkv=False),
                                 HEADS_MAJOR_PER_STEP),
                                ("fused LayerNorm, flash_save_probs", dict(fused, flash_save_probs=True),
                                 SAVE_PROBS_PER_STEP)):
        runs[what] = run_slice(torch, blk, card, per_step, "main path, " + what)
        torch.cuda.empty_cache()
    for what, (_, r) in runs.items():
        log(f"main path {what}: median step {r['median_ms']:.2f} ms, {r['pairs_per_s']:.1f} pairs/s, "
            f"peak memory {r['peak_gib']:.2f} GiB  [{card}]")
    log(f"main path as shipped: peak memory {runs['as shipped'][1]['peak_gib']:.2f} GiB with the site kernels "
        f"(each site saves its bits), {SHIPPED_PEAK_GIB_BEFORE:.2f} GiB before them (each site saved a bf16 "
        f"multiplier)  [{card}]")
    no_dropout = run_step_without_dropout(torch, fused)
    torch.cuda.empty_cache()
    run_cli(torch, card)
    torch.cuda.empty_cache()
    run_vqa_cli(torch, card)
    torch.cuda.empty_cache()
    run_nlvr2_cli(torch, card)
    torch.cuda.empty_cache()
    run_vqa_advanced_cli(torch, card)
    torch.cuda.empty_cache()
    run_flickr_phases(torch, card)
    torch.cuda.empty_cache()
    vcr = run_vcr_step(torch, card)
    torch.cuda.empty_cache()
    log(f"vcr step: median {vcr['median_ms']:.2f} ms, {vcr['images_per_s']:.2f} images/s, peak memory "
        f"{vcr['peak_gib']:.2f} GiB, detector forward alone {vcr['detector_forward_ms']:.2f} ms  [{card}]")
    run_vcr_cli(torch, card)
    torch.cuda.empty_cache()
    run_vcr_coco_cli(torch, card)
    torch.cuda.empty_cache()
    unsup = run_unsup_step(torch, card)
    torch.cuda.empty_cache()
    log(f"unsup step: V&L median {unsup['vl']['median_ms']:.2f} ms ({unsup['vl']['pairs_per_s']:.1f} pairs/s), "
        f"text-only median {unsup['text']['median_ms']:.2f} ms ({unsup['text']['pairs_per_s']:.1f} rows/s), "
        f"image-only median {unsup['image']['median_ms']:.2f} ms ({unsup['image']['pairs_per_s']:.1f} rows/s), peak "
        f"memory {unsup['peak_gib']:.2f} GiB  [{card}]")
    run_unsup_cli(torch, card)
    torch.cuda.empty_cache()
    run_text_pretrain_cli(torch, card)
    torch.cuda.empty_cache()
    run_unsup_vqa_cli(torch, card)
    torch.cuda.empty_cache()
    e2e = run_e2e_step(torch, card)
    torch.cuda.empty_cache()
    log(f"e2e step: median {e2e['median_ms']:.2f} ms, {e2e['images_per_s']:.2f} images/s, peak memory "
        f"{e2e['peak_gib']:.2f} GiB, batch {E2E_ROWS} (cut from 144)  [{card}]")
    run_th_restore_cli(torch, card)
    torch.cuda.empty_cache()
    run_tokenizer_check(card)
    run_process_batches(card)
    run_mesh_path(torch, card)
    torch.cuda.empty_cache()
    run_torchrun_cli(torch, card)
    torch.cuda.empty_cache()
    t_geo = time.perf_counter()
    geometries = run_geometry_cli(torch, card)
    log(f"phase 27, {len(GEOMETRIES)} geometries: {time.perf_counter() - t_geo:.1f} s  [{card}]")
    log(f"phase 27 bert-base fp32: median step {geometries[GEOMETRIES[F32_GEOMETRY][0]][2]:.2f} ms, "
        f"{BERT_BASE_F32_STEP_MS:.2f} ms on the first-design fp32 K1 forward  [{card}]")

    # launches: the fused-LayerNorm main path's STEPS steps; K7/K8 from its
    # dropout-0 step; K11/K12 and K13/K14 from the runs with their settings;
    # K15/K16 from the two attention tools; K3's mask from its wrapper's
    # calls in tools/dropout_steps.py, the site kernels from the as-shipped
    # steps
    launches = list(runs["fused LayerNorm"][0])
    launches[2] = mask_launches[2]
    launches[6:8] = no_dropout[6:8]
    launches[10:12] = runs["fused LayerNorm, packed_qkv false"][0][10:12]
    launches[12:14] = runs["fused LayerNorm, flash_save_probs"][0][12:14]
    launches[14:18] = exp_launches[14:18]
    launches[18:20] = runs["as shipped"][0][18:20]
    table = [dict(name=name, route="cuda", source=f"visualbert_torch/csrc/{src}", replaces=replaces, launches=n,
                  **rows[name]) for (name, _, src, replaces), n in zip(KERNELS, launches)]
    # the fp32 kernels: launches from the bert-base fp32 run
    _, f32_forms, _ = geometries[GEOMETRIES[F32_GEOMETRY][0]]
    table += [dict(name=name, route="cuda", source=f"visualbert_torch/csrc/{src}", replaces=replaces,
                   launches=f32_forms[wrapper].get("fp32", 0), **rows[name])
              for name, _, wrapper, src, replaces in F32_KERNELS]
    # K4-K14's other forms that phase 27 drives: launches from their geometry's run
    for name, _, wrapper, src, replaces, g, (dtype, width) in FORM_KERNELS:
        form = name[name.index("(") + 1:-1]
        launched = geometries[GEOMETRIES[g][0]][1][wrapper].get(form, 0)
        if launched == 0:
            raise SystemExit(f"{name}: no launch in phase 27's {GEOMETRIES[g][0]} run")
        table.append(dict(name=name, route="cuda", source=f"visualbert_torch/csrc/{src}", replaces=replaces,
                          launches=launched, **form_rows[(wrapper, dtype, width)]))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
