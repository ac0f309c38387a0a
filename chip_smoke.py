#!/usr/bin/env python3
"""Smoke run of unicore_tpu_torch on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in order; the run stops with a non-zero exit at the first
failure, and no phase is skipped:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the Smith-Waterman kernel (csrc/sw.cu), the
   banded one (csrc/banded.cu) and the direction-bit one (csrc/dirbits.cu)
   from the sources of this checkout (one nvcc per source, started
   together).
2. Kernel vs plain version on the card, bit-exact on (best, qend, tend):
   gapped with gap_window 64 and 0, and ungapped; bias off, on and at
   exactly +-bias_clip_bound; gaps 100/10 and 28/3; (B, L) in
   EXACT_SHAPES, (512, 128), (512, 256), (512, 512), (128, 1024), (192,
   512) and (16, 2048), with
   ragged lengths and planted homologies, half the mode and gap settings
   per shape and bias, the other half on the next.  Then the edges of the kernel's
   mapping (EDGE_SHAPES, B x Lt <= 64 x 4,096, Lq != Lt): every case of
   synthetic.sw_edge_pairs (lengths of 1, ties, a gap bonus, a bias past
   2^24, ...) and windows 0, 1, 2, 3, 48, 64, 100, Lt, 2*Lt and ungapped,
   half of them on each shape, alternating.
2b. The banded kernel (csrc/banded.cu, ops/banded_cuda.py) vs its plain
   version (ops/banded.py) on the card, bit-exact on (best, qend, tend):
   BANDED_GRID (W 33 to 2,048, one to four warps a pair, an odd W and
   one wider than the target) x every case of synthetic.banded_edge_pairs
   (seed diagonals planted, partly left of the target, off its end and
   wholly outside the matrix; lengths of 1, ties, a gap bonus, a negative
   gap extend, |qc| past 2^24), two of gap_window 64, 0 and ungapped per
   case, bias off on every other one, gaps 28/3 on the ragged case;
   gap windows 1, 3, 16, 100 and 1,024 (every E-window mode) at W 256,
   2,048 and 4,096; the engine's full batches (BANDED_ENGINE: 64 x 2,048
   x 2,048 at W 256, 32 x 2,048 x 1,024 at 512, 8 x 2,048 x 2,048 at
   2,048) in both engine modes; the edges of the kernel's table of
   columns a lane (BANDED_CLASS_EDGES: each band-width class's upper W
   and one past it) and a batch of 520 pairs, above the plain route's
   128 MB cap and the engine's batch_size (BANDED_OVER_CAP), in both
   engine modes; W = 8,192, the kernel's limit, and W = 8,193 refused.
2c. The direction-bit kernel (csrc/dirbits.cu, ops/dirbits_cuda.py) in
   both instances, the MSA's semi-global NW and the m8 traceback's local
   SW, against their plain versions (ops/nw_device.py::nw_forward_bits,
   ops/sw_bits.py::sw_forward_bits) on the card, bit-identical on whole
   (B, L1, L2) bits arrays and on (end_i, end_j, score): DIRBITS_GAPS
   (go < ge among them) x tests/test_torch_dirbits_kernel.py's shapes x
   random and tie scores x int16 and int32 S; the callers' full batches
   (NW 64 x 512², 16 x 2,048²; SW 64 x 64², 64 x 512², 32 x 1,024², 8 x
   2,048²) and B = 1 on their own generators' every kind, one scan a row
   (go >= ge) and two (go < ge) on each; each row-width class's upper
   edge of the kernel's table and one past it (DIRBITS_CLASSES, the
   table's C) in both scan modes; rows past one tile of 4,096 columns
   (3 x 50 x 4,097, 1 x 300 x 9,000).
2d. The SW kernel's int16 instance (dp_dtype="i16") against the plain
   int16 DP (ops/sw.py::sw_forward_i16) on the card, bit-exact on (best,
   qend, tend): I16_SHAPES ((512, 128) and (512, 256) at gaps 100/10, (64,
   1,024) and (16, 2,048) at 10/1), ragged, every fourth pair a self pair
   that reaches the cap or wraps, bias off and on (+255 on the self
   pairs' rows: cells past the int16 contract's < 150 assumption),
   gapped with gap windows 64 and 0 and ungapped, every mode on every
   shape; the 512 self pair of the highest-scoring residue at ge = 1
   capped at 30,000 at (288, 288) and wrapped after 32,760 at (314, 314),
   as JAX's interpret mode gives; and the int16 instance equal to the
   float32 one on every pair whose float32 best is below the cap.  Then
   the shapes that straddle the instance's fold of two int16 columns to a
   word (I16_SEAM: odd Lt, tlen past the middle, one to eight warps a
   pair, Lt at the contract's edge and at 4,096) at I16_SEAM_WINDOWS
   (windows of 0 to past Lt: each windowed-max mode) and ungapped; with
   I16_SHAPES they reach every instance the kernel's table compiles.  The
   int16 probe (scripts/torch_probe_i16.py:
   twenty int16 operations, each built by its own nvcc run and launched
   in its own process, held against numpy's wrapping arithmetic) starts
   with 6a, on the cores of phase 5's CPU run, and is read after 2d; any
   probe that fails fails the run.
3. Times per shape and mode (CUDA events around a run of back-to-back
   launches queued behind a spin of the card, so no gap of the host's
   falls between them, divided by their number, after a warm-up; every
   phase's kernel readings are taken so, time_cuda): kernel ms and
   GCUPS, the plain version's ms on the card, the bound, and the kernel's
   share of the bound.
   bound_ms = max(ops / peak scalar rate, bytes / memory rate), with
   ops = sum(qlen * tlen) * ops per cell, counted from the recurrence:
   gapped 14 (score 3, H0 3, F 3, E 3, H 1, best 1), ungapped 6 (score 3,
   H 2, best 1), one more for the bias add; peak scalar rate = SMs x 128
   FP32 lanes x the card's maximum SM clock (both read from the card);
   bytes = every input read once and every output written once, over
   3.35 TB/s (H100 SXM HBM3).  No single PyTorch call computes SW, so
   library_ms is null.
3e. The banded kernel per engine mode (gap_window 64 and ungapped, bias
   on) at the engine's full batches (BANDED_ENGINE; the JSON line takes
   BANDED_TIMED, the full batch at bucket 2,048 with the default band:
   64 pairs, Lq = Lt = 2,048, W 256): kernel ms and us per row, the plain
   version's ms on the card (one call, its ops warm from 2b), and the
   bound by phase 3's rule on the band
   cells sum(qlen * W).  Then the sweep of the kernel's columns a lane:
   every candidate C of each band-width class (BANDED_SWEEP,
   BANDED_SWEEP_COLUMNS: at least 4 warps a pair), bit-equal to the
   table's launch and timed at the class's batches, beside the table's
   choice.
3f. The sweep of the direction-bit kernel's columns a lane (C) per
   row-width class (DIRBITS_CLASSES: 64 to 4,096 columns), both
   instances, at the callers' full batches (dirbits_full_batch: NW int32
   as the merge pipeline packs it, SW int16 as sw_traceback_batch does):
   every C whose row is one tile, bit-equal to the table's launch and
   timed (CUDA events), ms and us per row beside the table's choice.
   Then, after phase 7a, the main path's launch shapes (phase 4's and
   7a's histograms, from the CLI's counters): per instance and bucket, a
   batch of the bucket's largest B held bit-identical to the plain
   version and timed, that time standing for each of the bucket's
   launches (the kernel's time is flat in B below the SM count):
   launches x (ms - bound) per bucket and instance, summed.
3g. The int16 instance beside the float32 one at I16_SHAPES (gap_window 64
   and ungapped, bias on): both kernels' ms, the plain int16 DP's ms on
   the card, and the int16 bound (i16_bound: the instructions the function
   needs per word of two cells, I16_PACKED_PER_WORD at the packed forms'
   issue rate that scripts/torch_probe_i16.py measures and
   I16_SCORE_PER_WORD at the issue limit, over the SMs at the maximum SM
   clock; or the bytes).
3b. The MSA's NW forward (ops/nw_device.py, PyTorch ops) on the card
   against the same function on the CPU, bit-identical on (bits, end_i,
   end_j, score): buckets 64, 512 and 2,048, batches of 1 and 64 (16 at
   2,048), gaps 2816/256 (random scores) and 1100/100 (all-zero or
   constant scores: ties everywhere; not at 2,048 x 16), ragged lengths
   down to 1.  Then at the merge pipeline's full batches (64 pairs at
   bucket 512, 16 at 2,048), on int32 scores (the pipeline's) and int16
   (nw_align_batch's): the kernel's ms (CUDA events), the plain version's
   ms per dispatch on the card and, at the JSON line's row (64 x 512,
   int32), on the CPU and the device's busy time
   inside one plain dispatch from a torch.profiler trace, and the bound,
   max(cells x DIRBITS_OPS_PER_CELL / peak scalar rate, (S, a byte of
   bits a cell, lengths and end cells) / 3.35 TB/s); the fused
   merge's count products (64 x 512 x 512) and the guide gram (2,048 x
   8,192 bags), each equal to its CPU result, and their times.
3c. The likelihood (phylo/likelihood.py, PyTorch ops) on the card against
   the same calls on the CPU, with `torch.set_float32_matmul_precision
   ("high")` set, so the engine's full-float32 guard is what keeps TF32
   out: at 20 taxa x 8,192 columns (JTT+F+I+G) `loglik_batch` and
   `site_loglik_batch` on 8 candidates of a 64-candidate NNI batch,
   `loglik_nni_moves`, a 5-step `optimize_blens` and the pattern-chunked
   path (chunks forced to 2,048 patterns; 8 and 4 candidates, 5 steps),
   and the incremental path at 64 taxa x 1,000 columns; the CPU side is
   what costs.  Tolerances as in
   tests/test_torch_phylo.py: lnL within LL_RTOL relative, sites within
   SITE_ATOL + SITE_RTOL |s|, after Adam lnL within BLEN_LL_RTOL and
   each length within BLEN_ATOL + BLEN_RTOL len.  Then ms per
   `loglik_batch` call (on the CPU for 8 candidates) and per Adam step,
   the device-busy share of Adam
   steps from a torch.profiler trace, and the bound of one `loglik_batch`:
   max(flops of its products at C x 20 x 20 per category and node /
   67 TFLOP/s FP32, bytes read and written once / 3.35 TB/s).
3d. The m8 traceback's DP (ops/sw_bits.py sw_forward_bits, PyTorch ops)
   on the card against the same function on the CPU, bit-identical on
   (bits, best_i, best_j, score): buckets 64, 512 and 2,048, batches of 1
   and the full batches sw_traceback_batch packs (64, 64, 8), gaps 100/10
   and 30/5 (one of them, alternating, at 2,048 x 8), random windows with
   a planted diagonal, gap windows that force E/F states, and tie windows
   (scores in {-1, 0, 1}), sizes ragged down to 1 x 1.  Then at the full
   batches of buckets 512 and 1,024 (int16 scores) 3b's times: the
   kernel's, the plain version's on the card, at 512 also on the CPU and
   its busy time, and the bound.
4. The main path end to end at a real size: 20 synthetic proteomes x 120
   proteins (2,400 sequences, under the 5,000-sequence cascade
   threshold), gene families evolved along a random species tree with
   substitutions and indels, some families missing or duplicated in some
   species, lengths lognormal (median 300, clipped to 50-2,000).
   `createdb mock`, `cluster`, `profile` and `tree -n` (foldmason) run as
   `python -m unicore_tpu_torch` calls one after another in one
   subprocess (cli_chain, as easy-core runs its stages) with a fresh HOME
   (so the E-value calibration runs on the kernel).  Prints the stage times, the
   pipeline and MSA counts, banded.seconds with its split (seed vote,
   packing, device), the banded batches (banded.launches), pairs and
   buckets, and the kernels' launches in that run; requires both
   modes of both SW kernels launched, every banded batch through the
   banded kernel, every NW forward of the tree stage (msa.dispatches)
   through the direction-bit kernel, a cluster purity against the
   generating families
   of at least PURITY_FLOOR, a filtered MSA for every core gene whose rows
   ungapped are the gene's input sequences, and a supermatrix with one row
   per species whose partitions tile its width.  Then `tree` again on the
   same output directory with its defaults (iqtree, -m JTT+F+I+G -B 1000):
   it takes the skip path and runs inference alone, timed apart.  Requires
   iqtree.treefile with the species as leaves, a support in [0, 100] on
   every internal split but at most one (the JAX package, and the port
   with it, leaves the root split of the rooted search tree unlabelled
   when both root children are internal), a finite lnL in iqtree.iqtree,
   tree.chk "1", and
   a normalized RF distance to the tree the proteomes evolved along
   (synthetic.species_tree) of at most RF_FLOOR.
5. Cross-check on 5 species x 12 proteins (one family longer than 1,024:
   the banded path and the 2,048 NW bucket): `easy-core` with its
   defaults, then `tree -n -A mafft` and `tree -n -A mafft-linsi` on its
   outputs, and `tree -T fasttree` and `tree -T raxml-ng` on copies of its
   supermatrix (the skip path), on CUDA and on the CPU
   (UNICORE_TPU_TORCH_DEVICE=cpu), each with its own HOME.  The same
   files, every one before inference byte-identical; the inference
   outputs parsed: the same topology (RF 0), branch lengths within
   BLEN_ATOL + BLEN_RTOL len, supports within SUPPORT_POINTS, lnL within
   BLEN_LL_RTOL, every other report line equal but `seconds`; no kernel
   launched by the CPU run, and every NW forward of the CUDA easy-core
   through the direction-bit kernel.
6. The paths of the cascade and gene-tree slice, at cut depths:
   6a. The cascade on 20 x CASCADE_PER_SPECIES proteomes of phase 4's
       generator and seed (1,200 sequences) through `createdb mock` into a
       directory of their own, then `cluster_db(...,
       cascade_threshold=CASCADE_THRESHOLD)` in process on CUDA.  Requires every sequence in exactly one cluster, purity of at
       least PURITY_FLOOR and both kernel modes launched during the call;
       prints the canopy representatives, the verify pairs, the
       representative round's pairs and edges, whether its empirical null
       was fitted (below 5,000 pairs it is not), the clusters and the time.
   6b. The cascade at CROSS_CASCADE_THRESHOLD on 5 x
       CROSS_CASCADE_PER_SPECIES proteomes of phase 5's seed (80
       sequences), on CUDA and inside phase 5's CPU run: clust.tsv
       byte-identical, the canopy merging some sequences and the
       representative round run.
   6c. `gene-tree` with its defaults (iqtree -m JTT+F+I+G -B 1000) on
       GENETREE_GENES core gene of phase 4, the first of the first two (in
       name order) to share a (taxa, pattern bucket) lockstep group: per
       gene a tree over its taxa, supports in [0, 100]
       (one split may have none), a finite lnL, the unpadded pattern count
       in iqtree.iqtree; seconds and Adam steps per gene.  Beside it, on
       other cores, the lockstep inference (fasttree, -gamma, in process)
       of the first two core genes of phase 5's CUDA output to share a
       lockstep group (5 taxa) against a solo inference of each gene (a
       process each): the same splits but those on a branch of at most
       RESOLVED in the tree that has them (RF is printed), lnL within
       SOLO_LL_RTOL.  Then the slice's new device work timed alone: a
       canopy gram and one gene-batched likelihood call over phase 4's
       group against the per-gene calls.
   6d. `gene-tree` with its defaults on copies of phase 5's first
       CROSS_GENETREE_GENES core genes, on CUDA and inside phase 5's CPU
       run: the outputs compared as phase 5 compares its trees.
   6e. `config --check` on the card: exit 0, CUDA with 1 device and the
       card's name, every engine ok but mmseqs (no factory, as in JAX);
       a process of its own, started with the run on the CPU run's cores
       and read after 6a.
7. The search path and partitioned models:
   7a. `search` at phase 4's full width on CUDA (a CLI subprocess with a
       fresh HOME, so the E-value fit runs on the kernel): a reference DB
       of one sequence per SEARCH_REF_STRIDE-th core gene of phase 4 and
       per core gene longer than SEARCH_REF_LONG (its cluster
       representative's AA and mock 3Di, named AF-<name>-F1) against
       phase 4's 2,400-sequence proteome DB with search's default
       options, then `profile` on its m8 (in process: host code).  Requires every reference's
       self hit with fident 1.000, mismatch 0 and gapopen 0, the m8
       grouped by reference, both kernel modes launched, every traceback
       forward (traceback.dispatches) through the direction-bit kernel,
       search.chk "1" and, where a reference is longer than 1,024, the
       banded traceback taken.  Prints the candidate pairs, the hits, the traceback
       windows of each route, the seconds of the search and of
       traceback_fill, and the core genes profile finds.
   7b. `easy-search` with its defaults on phase 5's proteomes against a
       reference DB made as 7a's from phase 5's core genes, on CUDA and
       inside phase 5's CPU run: every file before inference
       byte-identical, the tree files compared as phase 5 compares them.
   7c. `tree -m JTT+F+I+G -B 1000 -p combined.fasta.partitions` on a copy
       of phase 5's supermatrix (the skip path), on CUDA and inside phase
       5's CPU run: compared as phase 5 compares its trees, n_partitions
       in iqtree.iqtree the partition file's line count.
   7d. The partitioned engine at phase 4's full width (20 taxa, its
       partition file, the whole supermatrix, phase 4's final tree) on the
       card against the CPU under TF32 settings: loglik within LL_RTOL,
       site_loglik within SITE_ATOL + SITE_RTOL |s|; ms per call and per
       Adam step of a PARTITION_ADAM_STEPS-step optimize_blens, its
       device-busy share, each call's bound as phase 3c's on the padded
       shapes, and an extrapolation (marked so) of a full `tree -p -B
       1000` at this size from phase 4's counts.
8. ProstT5 (`createdb` with a model directory) at ProtT5-XL's full width:
   8a. A synthetic checkpoint in the real HF layout, 24 layers at
       T5Config()'s geometry (1.2 B parameters, float16
       pytorch_model.bin drawn on the card from a seeded
       torch.Generator), through `createdb IN OUT MODEL_DIR` on CUDA (a
       CLI subprocess) on PROSTT5_SPECIES proteomes of phase 4's seed and
       size (1,200 proteins) plus one 5,000-residue protein (the windowed
       path): every 3Di string of its protein's
       length and of 3Di letters only.  Prints the stage's seconds, the
       load, residues and padded tokens per second and the peak memory;
       then, in process, ms per full batch of encoder_forward and
       cnn_head at buckets 128, 384 and 2,176 (CUDA events), each
       batch's bound (flops over 989 TFLOP/s dense bf16, weight and
       residual-stream bytes over 3.35 TB/s; data sheet peaks) and the
       peak memory, under 40 GiB at 2,176.
   8b. The same width with 2 of 24 layers (a checkpoint of its own) on
       the card against the CPU, with TF32 and bf16 reductions requested
       by the caller: hidden states and logits in float32 within rtol
       1e-4 and atol 1e-4 max|ref|, and the bf16 engines' 3Di on 8
       sequences of 30-120 residues under the tie rule of
       tests/torch_port_helpers.py.

9. The multi-device paths (parallel/mesh.py), on a logical mesh of
   LOGICAL_SHARDS shards of the card, each shard in turn on it (and over
   every card where there are several): what a shard computes is what a
   card of a real mesh would, so this shows correctness, not multi-card
   speed.
   9a. `sw_forward_sharded` bit-exact against one `sw_forward_cuda` call
       and the plain version: at (512, 512) gapped with gap_window 64 and
       bias on, gapped with gap_window 0 and no bias, ungapped with bias,
       and 500 pairs padded as the engine pads (to 4 x 16); then its ms
       at (512, 512) (the engine's setting) beside the single call's and
       the plain version's, and its bound (the shards' bounds summed over
       the distinct devices).
   9b. `sw_forward_banded_sharded` (32 pairs at bucket 1,024, W 256,
       gapped and ungapped; one banded kernel launch per shard) against
       one call of the plain version, and `nw_forward_bits_sharded` (64
       pairs at bucket 512; one direction-bit kernel launch per shard)
       against one call of the plain version, bit-identical.
   9c. Under TF32 settings, `loglik_batch` and `site_loglik_batch` with
       mesh= on phase 3c's 64 candidates and `_loglik_multi_sharded` on 3
       genes at 3c's width x 8 candidates against one device, within rtol
       2e-5 and atol 1e-3 (tests/test_sharded_backhalf.py's tolerance).
   9d. With `local_mesh` patched to the logical mesh, against the same
       calls unpatched: `AlignmentEngine.align_pairs` on phase 4's first
       SHARD_SPECIES x 120 sequences (their prefilter pairs, the E-value
       fit made anew on each side) with equal hits and fit,
       `nw_align_batch` on 40 score matrices with equal paths, and
       `ProstT5Engine.predict` (8b's checkpoint, bf16) with the 3Di under
       the tie rule.  The sharded route's launches are counted from 0
       over the patched calls; both modes must have launched.
   9e. Two ranks of `python -m unicore_tpu_torch.parallel.dist_check`
       through `initialize_distributed` (gloo, each rank's kernel on the
       card, collectives on host copies), started before 8b and joined
       after 9d: each scores only its block of an SW batch, all-reduces
       the hit count, all-gathers the results and checks both against
       the whole batch.
   9f. The native featurizer on phase 4's 2,400 sequences, bit-identical
       to its plain version; both timed.
10. ProstT5's training step (parallel/sharding.py), one sub-phase after
   another, each model freed before the next; tolerances those of
   tests/test_torch_train.py (LOSS_RTOL, GRAD_RTOL and its Adam rule):
   10a. The full-width float32 step (T5Config(): 24 layers, 1.2 B
       parameters drawn on the card from TRAIN_SEED) unsharded on a
       seeded 4 x 512 batch of ragged rows: a warm-up Adam step, then
       TRAIN_STEPS timed ones at lr TRAIN_LR (CUDA events); every loss
       finite, the last below the first.  Prints ms per step, the bound
       (3 x the forward's flops over 67 TFLOP/s FP32; parameters and
       Adam's moments read and written once over 3.35 TB/s), peak memory
       and tokens per second.
   10b. The same from the same parameters and batch at tp = TRAIN_TP on a
       logical mesh of the card: losses within LOSS_RTOL of 10a's; the
       warm-up gradients of blocks 0 and 23's wo and the head's two
       convolutions within GRAD_RTOL of max|g|, their parameters after
       the steps under the Adam rule.
   10c. 2 of 24 layers at full width, one step at (dp, tp) = (2, 2) on a
       logical mesh of the card against the unsharded model on the CPU
       (2 x 128 tokens): the loss, every gradient, every update.
   10d. graft_entry.dryrun_multichip(4) on a logical mesh of the card.
   10e. make_sharded_predict at tp = TRAIN_TP on 8b's bf16 checkpoint:
       3Di against one device's under the tie rule.
   10f. Training across torch.distributed ranks (`python -m
       unicore_tpu_torch.parallel.dist_check --train DPxTP`, one process
       per rank, gloo on this card, collectives through host copies; each
       rank a RankShardedProstT5 of its tp slice and dp block; they
       draw their parameters on the card from 10a's or 10c's seed):
       10f-i. 10c's layers, batch and seed at (dp, tp) = RANK_MESH over 4
       ranks, started before 8b and joined after 10e: one step
       against 10c's one-process step at (2, 2) on the logical mesh, to
       10c's tolerances; every rank's replicated leaves bit-identical.
       10f-ii. 24 layers at full width over RANK_TP ranks at (1,
       RANK_TP), from 10a's seed and batch, RANK_STEPS steps: the first
       loss within LOSS_RTOL of 10a's, the losses finite and falling;
       each rank's ms per step after the first and peak memory.

Order of the run: phase 5's CPU run (6b's CPU run beside its easy-core;
then three sides, each in one process: 7c and 6d; tree -T raxml-ng and
tree -T fasttree; the two other aligners and 7b) and 6e's `config
--check` start first, on every core but two, and go on beside phase 1
and the checks of phases 2, 2b, 3c and 3d, on those two; then 6a, the
checks of 2c and 3b, 6e's reading and 2d (in a thread of their own)
beside phase 5's CUDA run (6b beside its easy-core; then three sides,
each in one process: raxml-ng; 7c and 6d; the rest and 7b), on every
core, and the int16 probe on the others.  Once it has ended, phase 3
and the times of phases 3b-3g, phase 4, 7a and 7d run with nothing
beside them, then 6c, 8a, 8b, 9 and 10 (9e's and 10f-i's ranks started
before 8b, 9e's joined after 9d and 10f-i's after 10e; 10f-ii's started
after 10b).  Each phase's start and end on the
script's clock is printed as a "[clock]" line, and at the end a table of
them, by start, with what ran beside each (critical_path).  The cores
are a request: where the kernel does not enforce affinity (some
container kernels report the mask they were given and run every thread
on every core), the sides share all cores.

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel mode: launches in phase 4 and 7a, times and bound at (512, 512),
the main path's most common bucket, for the banded kernel 3e's at
BANDED_TIMED, for the direction-bit kernel 3b's NW at 64 x 512² (int32)
and 3d's SW at 64 x 512² (int16), for the packed int16 instance 3g's at
I16_TIMED with no launch on the main path, and for the probe the sums
over its twenty kernels of one launch's ms, numpy's ms and the bytes'
bound; 6a
prints the cascade's launches;
phases 8 and 10 add no kernel: the ProstT5 model is PyTorch ops; a row
for the sharded route: 9d's launches, 9a's times and bound);
the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits non-zero before
printing any result.  Nothing here imports JAX or unicore_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(512, 128), (512, 256), (512, 512), (512, 1024), (192, 512), (48, 2048)]
# phase 2's shapes: SHAPES with fewer pairs at Lt 1,024 and 2,048, the same widths and so the
# same instances of the kernel's table
EXACT_SHAPES = [(512, 128), (512, 256), (512, 512), (128, 1024), (192, 512), (16, 2048)]
MODES = {"gapped_w64": dict(gap_window=64), "gapped_w0": dict(gap_window=0),
         "ungapped": dict(ungapped=True)}
GAPS = [(100.0, 10.0), (28.0, 3.0)]
TIMED_MODES = {"gapped": dict(gap_window=64), "ungapped": dict(ungapped=True)}  # the engine's
OPS_PER_CELL = {"gapped": 14, "ungapped": 6}  # +1 with the bias add
LANES_PER_SM = 128      # FP32 lanes of a Hopper SM
SPIN_CYCLES_PER_S = 2.0e9  # time_cuda's spin: cycles a second, at or above the card's SM clock
SPIN_MAX_S = 0.1  # the longest spin time_cuda queues its calls behind
HBM_BYTES_PER_S = 3.35e12
KERNEL_SHAPE = (512, 512)
# phases 2d and 3g, the int16 instance (dp_dtype="i16"): (B, L, go, ge), the
# engine's buckets inside the int16 contract (L*ge + 30150 < 32767)
I16_SHAPES = [(512, 128, 100.0, 10.0), (512, 256, 100.0, 10.0), (64, 1024, 10.0, 1.0), (16, 2048, 10.0, 1.0)]
I16_MODES = {"gapped_w64": dict(gap_window=64), "gapped_w0": dict(gap_window=0),
             "ungapped": dict(ungapped=True)}
I16_TIMED = (512, 256)  # the JSON line's int16 rows
# The int16 bound counts warp-instructions per warp-word (32 words of two
# cells each, the packed layout) that the int16 function needs: packed
# int16x2 and DPX forms, each fused form one instruction (gapped, window
# 64: F 2, H0 1, t = H0 + j*ge 1, the window's prefix and suffix maxima 1
# + 1, E and its max with H0 2, the cap 1, the best 0.5 with a three-way
# max; ungapped: H 1, the best 0.5) at I16_PACKED_RATE, and the score at
# the issue limit of four warp-instructions an SM a cycle (faster than any
# of its instructions, so the bound stays a lower one): per word four table
# reads, two three-input adds (the bias in them) and a pack, where every
# cell sums to an integer of at most 256 (bfloat16 holds it, so the
# plain version's rounding and conversion leave it as it is); the other
# rows add the rounding and the conversion of each cell (4 a word).
I16_PACKED_PER_WORD = {"gapped": 9.5, "ungapped": 1.5}
I16_SCORE_PER_WORD = {True: 7, False: 11}  # fast rows, other rows
# the packed forms' issue rate, warp-instructions an SM a cycle: 64 lanes
# (scripts/torch_probe_i16.py measures 1.93-1.99 for each form the count
# uses, its own loop's instructions among them)
I16_PACKED_RATE = 2.0
ISSUE_LIMIT = 4  # warp-instructions an SM a cycle: one a scheduler
I16_FAST_MAX = 256
I16_CAP_PAIR = {False: (30000.0, 288, 288), True: (32760.0, 314, 314)}  # 512 self pair, ge 1
# 2d's shapes across the int16 instance's fold (B, Lq, Lt, go, ge): odd Lt,
# one column past a one-warp block, several warps, the contract's edge at
# ge 1 (2,616 + 30,150 < 32,767) and MAX_LT at ge 0; and their windows
I16_SEAM = [(64, 100, 127, 100.0, 10.0), (32, 200, 257, 28.0, 3.0), (16, 300, 1023, 10.0, 1.0),
            (8, 100, 2616, 10.0, 1.0), (4, 40, 4096, 10.0, 0.0)]
I16_SEAM_WINDOWS = [0, 1, 3, 64, 100, 5000]
# 2b: the banded kernel's (B, Lq, Lt, W), as tests/test_torch_banded_cuda.py: single and
# multi-warp bands, an odd W and a W wider than the target
BANDED_GRID = [(64, 256, 256, 128), (32, 512, 600, 256), (16, 700, 500, 512), (8, 300, 2100, 1024),
               (4, 200, 3000, 2048), (8, 150, 120, 33), (8, 100, 90, 300)]
BANDED_ENGINE = [(64, 2048, 2048, 256), (32, 2048, 1024, 512), (8, 2048, 2048, 2048)]  # the engine's full batches
BANDED_WINDOWS = [1, 3, 16, 100, 1024]  # 2b: E windows inside a lane, across lanes and across warps
# 3e's JSON row: 64 pairs at bucket 2,048 with the default band, the plain route's full batch (the
# kernel route sends up to the engine's batch_size, 512: phase 4's launches carry 439-533 pairs at
# W 256 and 512, timed by the sweep's (512, 2048, 2048, W) batches)
BANDED_TIMED = (64, 2048, 2048, 256)
# 2b: the edges of the kernel's table (each band-width class's upper W and one past it), and
# one batch above the plain route's 128 MB cap (256 pairs here) and the engine's batch_size
BANDED_CLASS_EDGES = [128, 129, 256, 257, 384, 385, 512, 513, 1024, 1025, 2048, 2049, 4096, 4097]
BANDED_OVER_CAP = (520, 512, 512, 256)  # 272 MB of band
# 3e's sweep of the kernel's columns a lane (C) per band-width class (its upper W): the
# engine's batches in the class, (B, Lq, Lt, W), with the cap lifted (phase 4's rescore
# buckets hold 439-533 pairs at W 256 and 512: scripts/torch_banded_buckets.py), and the C
# that keep >= 4 warps a pair at every W of the class and <= 16 (banded_cuda.MAX_THREADS)
BANDED_SWEEP = {128: [(64, 2048, 128, 128)],
                256: [(64, 2048, 2048, 256), (512, 2048, 2048, 256)],
                384: [(64, 2048, 1024, 384)],
                512: [(32, 2048, 1024, 512), (512, 1024, 2048, 512), (512, 2048, 2048, 512)],
                1024: [(64, 2048, 2048, 1024)],
                2048: [(8, 2048, 2048, 2048), (64, 2048, 2048, 2048)]}
BANDED_SWEEP_COLUMNS = {128: (1,), 256: (1, 2), 384: (1, 2), 512: (1, 2, 4), 1024: (2, 4), 2048: (4, 8)}
# (B, Lq, Lt) at the edges of the kernel's mapping: a lane, a warp of 32*C
# columns (C = 4, 8, 16) and one past it, 2 to 8 warps per pair
EDGE_SHAPES = [(13, 100, 1), (5, 64, 31), (13, 40, 33), (64, 80, 65), (5, 300, 129),
               (13, 200, 257), (5, 600, 511), (13, 400, 513), (5, 700, 1025),
               (13, 1500, 2048), (8, 500, 4096)]
EDGE_WINDOWS = [0, 1, 2, 3, 48, 64, 100]
# Share of clustered sequences in their family's majority cluster.  Not 1:
# the E-value null is simulated from the published 3Di background, which
# the mock 3Di backend does not follow, so a few chance hits between
# unrelated families pass the gate and merge clusters.  On a 489-sequence
# subset of 8 x 480 data from write_proteomes (tests/torch_purity_reading.py,
# on the CPU) the JAX package and the port both reach 0.9939 with identical
# clust.tsv, and 1.0 once the null's 3Di is made by the mock backend.
# Chance merges per sequence grow at most linearly with the number of
# sequences: at 3,840, 1 - 0.0061 * 3840 / 489 = 0.952; at 2,400, 0.970.
PURITY_FLOOR = 0.95
N_SPECIES, PER_SPECIES = 20, 120
NW_CHECKS = [(64, 1), (64, 64), (512, 1), (512, 64), (2048, 1), (2048, 16)]  # (bucket, batch)
NW_GAPS = [(2816, 256), (1100, 100)]  # the MSA engines' 11/1 in QUANT units; another pair
NW_TIMED = [(512, 64), (2048, 16)]  # full batches of the merge pipeline's caps
FP32_FLOPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
PHYLO = dict(n=20, L=8192, batch=64, model="JTT+F+I+G", alpha=0.7, p_inv=0.05, seed=5,
             steps=5, cpu_batch=8)  # Adam steps and candidates of the CUDA-vs-CPU checks
PHYLO_INC = dict(n=64, L=1000, seed=6)  # the incremental NNI path starts at 48 taxa
ADAM_TIMED_STEPS = 60  # 3c's timed optimize_blens call
# likelihood tolerances, CUDA against the CPU (those of tests/test_torch_phylo.py)
LL_RTOL, SITE_ATOL, SITE_RTOL = 1e-5, 1e-4, 1e-3
BLEN_LL_RTOL, BLEN_ATOL, BLEN_RTOL = 1e-4, 1e-3, 1e-2
SUPPORT_POINTS = 1.0
RF_FLOOR = 0.2  # normalized RF of phase 4's tree to the generating species tree
CROSS_SPECIES, CROSS_PER_SPECIES = 5, 12
CASCADE_PER_SPECIES = 60       # phase 6a: 20 x 60 proteomes (1,200 sequences; phase 4's seed) ...
CASCADE_THRESHOLD = 500        # ... go through the cascade
CROSS_CASCADE_PER_SPECIES = 16  # phase 6b: 5 x 16 proteomes (80 sequences; phase 5's seed) ...
CROSS_CASCADE_THRESHOLD = 50   # ... go through the cascade
GENETREE_GENES = 1             # phase 6c: core genes of phase 4 through gene-tree (timed)
CROSS_GENETREE_GENES = 1       # phase 6d: core genes of phase 5
SOLO_LL_RTOL = 1e-3            # phase 6c: lockstep against solo inference (tests/test_genetree_batched.py)
# 6c: a split in one of the lockstep and solo trees only must have a branch
# this short: a zero-length edge is a polytomy that float noise resolves
# either way (the rule of tests/torch_port_helpers.py::assert_same_tree)
RESOLVED = 2e-3
CHECKABLE = ("foldseek", "foldmason", "mafft", "mafft-linsi", "iqtree", "fasttree", "raxml-ng")
# phase 3d: sw_forward_bits (ops/sw_bits.py) CUDA vs CPU at (bucket, batch):
# batches of 1 and the full batches sw_traceback_batch packs (64 MB of int16
# scores: 64 at 64 and 512, 32 at 1,024, 8 at 2,048)
SWB_CHECKS = [(64, 1), (64, 64), (512, 1), (512, 64), (2048, 1), (2048, 8)]
SWB_GAPS = [(100, 10), (30, 5)]  # the engine's 10/1 in its integer units; another pair
SWB_TIMED = [(512, 64), (1024, 32)]
# phase 2c: the direction-bit kernel (csrc/dirbits.cu) against its plain
# versions: tests/test_torch_dirbits_kernel.py's gaps (the last go < ge)
# and shapes, the callers' full batches (B, bucket) with B = 1, and rows
# past one block's tile of 4,096 columns
DIRBITS_GAPS = [(2816, 256), (1100, 100), (100, 10), (10, 10), (5, 20)]
DIRBITS_GRID = [(6, 24, 17), (1, 1, 1)]
DIRBITS_FULL = {"nw": [(64, 512), (16, 2048), (1, 512)],
                "sw_bits": [(64, 64), (64, 512), (32, 1024), (8, 2048), (1, 2048)]}
DIRBITS_WIDE = [(3, 50, 4097), (1, 300, 9000)]  # (B, L1, L2)
# 2c and 3f: the row-width classes of the kernel's table (their upper L2;
# past the last, tiles of 4,096 columns); 2c holds each edge and one past
# it at (B, L1) = DIRBITS_EDGE_BATCH
DIRBITS_CLASSES = [64, 128, 256, 512, 1024, 2048, 4096]
DIRBITS_EDGE_BATCH = (3, 24)
# integer operations a cell, counted from the recurrence: F 3 (two
# subtractions, max), h0 2 (add, max), Escan 3 (add j*ge, prefix max,
# subtract j*ge + go - ge), H 1, E 3 (as Escan), bits 8 (four comparisons,
# H(j-1) - go, three or-shifts); SW 4 more (the clamp at 0, H == 0, its
# or-shift, the best cell)
DIRBITS_OPS_PER_CELL = {"nw": 20, "sw_bits": 24}
SEARCH_OPTIONS = "-c 0.8"  # phase 7a/7b: search's default
SEARCH_REF_STRIDE = 3      # phase 7a: every third core gene of phase 4 a reference ...
SEARCH_REF_LONG = 1024     # ... and every one longer than this (the banded traceback)
PARTITION_OPTIONS = "-m JTT+F+I+G -B 1000 -p {}"  # phase 7c: tree's defaults and a partition file
PARTITION_ADAM_STEPS = 4   # phase 7d: the timed optimize_blens ...
PROFILED_STEPS = 3         # ... and the profiled one
# phase 8: ProstT5 at ProtT5-XL's width (models/prostt5.py T5Config())
PROSTT5_SEED = 20261017
PROSTT5_PREFIX = 128      # <AA2fold> after the 128 base pieces
PROSTT5_SPECIES = 4        # 8a: synthetic proteomes of phase 4's seed and size (480 proteins) ...
LONG_PROTEIN = 5000        # ... and one protein past the 2,048-residue window: three windows at bucket 2,176
PROSTT5_BUCKETS = (128, 384, 2176)  # 8a: full batches timed in process
PROFILE_TOP = 8            # prostt5_profile: kernels listed per bucket
PROSTT5_REPS = 2           # ... timed launches after two warm-ups (about 1 s each at 2,176)
CROSS_PROSTT5_LAYERS = 2   # 8b: 2 of 24 layers, CUDA against the CPU
CROSS_PROSTT5_SEQS = 8     # ... of 30-120 residues, one bucket
PROSTT5_RTOL = 1e-4        # hidden states and logits: rtol, atol a share of max|ref| (tests/test_torch_prostt5.py)
# 8b's bf16 checks, those of tests/torch_port_helpers.py: the spread
# limit (assert_bf16_spread) and the tie rule
BF16_SPREAD, TIE_RTOL_BF16, MIN_AGREE = 0.4, 2.0 ** -6, 0.98
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# phase 9: the multi-device paths on a logical mesh of shards of one card
LOGICAL_SHARDS = 4
RAGGED_B = 500             # 9a: a batch the engine pads to 512 (4 shards x 16 pairs)
SHARDED_REPS = 20          # 9a: timed launches of sw_forward_sharded and of the single call
BANDED_9B = (32, 1024, 256)  # 9b: banded (B, L, W): pairs past long_threshold
NW_9B = (64, 512)          # 9b: NW (B, bucket): a full merge batch
GENES_9C, CANDIDATES_9C = 3, 8  # 9c: genes (4 shards: one pad gene) and candidates each, at 3c's width
SHARD_LL_RTOL, SHARD_LL_ATOL = 2e-5, 1e-3  # 9c: sharded vs single (tests/test_sharded_backhalf.py)
SHARD_SPECIES = 2          # 9d: phase 4's first 2 x 120 sequences through align_pairs
NW_MATRICES_9D = 40        # 9d: score matrices through nw_align_batch
DIST_RANKS = 2             # 9e
# phase 10: ProstT5's training step (parallel/sharding.py) at ProtT5-XL's width
TRAIN_SEED = 20261018
TRAIN_BATCH = (4, 512)     # 10a/10b: B x L, ragged rows
TRAIN_STEPS = 3            # ... timed Adam steps after one warm-up step
TRAIN_LR = 1e-4
TRAIN_TP = 4               # 10b and 10e: tp over a logical mesh of the card
CROSS_TRAIN = (2, 2, 128)  # 10c: layers, B, L at (dp, tp) = (2, 2), CUDA against the CPU
RANK_MESH = (2, 2)         # 10f-i: gloo ranks (dp, tp), 10c's layers, batch and seed
RANK_TP = 2                # 10f-ii: gloo ranks at (1, RANK_TP), 10a's seed and batch ...
RANK_STEPS = 3             # ... Adam steps (the first a warm-up)
# tests/test_torch_train.py's tolerances, sharded against unsharded: the
# loss, each gradient tensor (of max|g_ref|), the Adam updates (its rule)
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL, STRONG, GRAD_NOISE = 1e-5, 1e-4, 1e-3, 1e-3, 1e-6
RELU_FLIP_L2 = 1e-2        # gradients below a relu, of their norm (check_grads)
_CLOCK = [time.perf_counter()]  # the script's clock; main() restarts it


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SmokeError(what)


def clock():
    """Seconds on the script's clock."""
    return time.perf_counter() - _CLOCK[0]


_SPANS = []  # (lane, name, start, end) of every span, for critical_path()


def record_span(name, t0, t1, lane=None):
    """Log a phase's start and end on the script's clock and keep them;
    `lane` names what ran it (default: "main" or "side", by thread)."""
    lane = lane or ("main" if threading.current_thread() is threading.main_thread() else "side")
    _SPANS.append((lane, name, t0, t1))
    log(f"[clock] {name}: {t0:.1f} -> {t1:.1f} s")


@contextlib.contextmanager
def span(name, lane=None):
    """Log a phase's start and end on the script's clock."""
    t0 = clock()
    try:
        yield
    finally:
        record_span(name, t0, clock(), lane)


def critical_path():
    """The run's spans as a table, by start: lane, start, end, seconds,
    and the spans of other lanes that ran beside each for a second or
    more.  Main-lane spans that hold no other are the chain the run's
    wall time is the sum of; its "wait" spans are where the main lane
    waited on another (phase 5's CPU run, 6a/6e/2d's thread, the probe)."""
    spans = sorted(_SPANS, key=lambda x: (x[2], -x[3]))
    log("[critical path] lane   start     end  seconds  span  | beside (other lanes, >= 1 s of overlap)")
    for lane, name, t0, t1 in spans:
        depth = sum(1 for l2, n2, a, b in spans if l2 == lane and name.startswith(n2) and n2 != name
                    and a <= t0 and t1 <= b)
        beside = sorted({n2 for l2, n2, a, b in spans if l2 != lane and min(t1, b) - max(t0, a) >= 1.0
                         and not any(l3 == l2 and n2.startswith(n3) and n3 != n2 and a3 <= a and b <= b3
                                     for l3, n3, a3, b3 in spans)})
        log(f"[critical path] {lane:6s} {t0:6.1f}  {t1:6.1f}  {t1 - t0:7.1f}  {'  ' * depth}{name}"
            + (f"  | {'; '.join(beside)}" if beside else ""))


# ---------------------------------------------------------------------------
# phase 2/3 inputs
# ---------------------------------------------------------------------------

def sw_inputs(rng, B, L, bias, saa, s3d, dev):
    """Ragged code pairs; every other pair carries a planted homolog of a
    query window (substitutions plus one insertion and one deletion)."""
    import torch

    from unicore_tpu_torch.align.bias import bias_clip_bound

    qa = rng.randint(0, 20, (B, L)).astype(np.int32)
    qs = rng.randint(0, 20, (B, L)).astype(np.int32)
    ta = rng.randint(0, 20, (B, L)).astype(np.int32)
    ts = rng.randint(0, 20, (B, L)).astype(np.int32)
    ql = rng.randint(max(8, L // 4), L + 1, B).astype(np.int32)
    tl = rng.randint(max(8, L // 4), L + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        w = int(min(ql[b], tl[b]) * 0.8)
        off_q, off_t = rng.randint(0, ql[b] - w + 1), rng.randint(0, tl[b] - w + 1)
        seg_a, seg_s = qa[b, off_q:off_q + w].copy(), qs[b, off_q:off_q + w].copy()
        sub = rng.randint(0, w, w // 6)
        seg_a[sub] = rng.randint(0, 20, len(sub))
        c1, c2 = sorted(rng.randint(4, w - 4, 2))
        seg_a = np.concatenate([seg_a[:c1], rng.randint(0, 20, 5), seg_a[c1:c2], seg_a[c2 + 4:]])[:w]
        seg_s = np.concatenate([seg_s[:c1], rng.randint(0, 20, 5), seg_s[c1:c2], seg_s[c2 + 4:]])[:w]
        ta[b, off_t:off_t + len(seg_a)] = seg_a
        ts[b, off_t:off_t + len(seg_s)] = seg_s
    if bias == "off":
        qc = None
    elif bias == "on":
        qc = rng.randint(-60, 40, (B, L)).astype(np.int32)
    else:
        bound = int(bias_clip_bound(saa, s3d, 4.0, 6.0))
        qc = rng.choice([-bound, bound], size=(B, L)).astype(np.int32)
    t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa: E731
    return [t(x) for x in (qa, qs, ta, ts, ql, tl)], t(qc)


def cells_of(args):
    ql, tl = args[4].double(), args[5].double()
    return float((ql * tl).sum())


def bytes_of(args, qc):
    n = sum(x.numel() * x.element_size() for x in args)
    n += 0 if qc is None else qc.numel() * qc.element_size()
    return n + 2 * 21 * 21 * 4 + args[0].shape[0] * 12


def i16_bound(ctx, args, qc, kind, w_aa=None, w_3di=None):
    """(bound_ms, ops_ms, bytes_ms) of one launch of the int16 instance on
    these inputs: the instructions of I16_PACKED_PER_WORD and
    I16_SCORE_PER_WORD over the card's SMs at its maximum SM clock, or the
    bytes over HBM_BYTES_PER_S."""
    import torch

    from unicore_tpu_torch.ops.sw import W_3DI_INT, W_AA_INT

    w_aa, w_3di = W_AA_INT if w_aa is None else w_aa, W_3DI_INT if w_3di is None else w_3di
    tabs = [(m * w).to(torch.bfloat16).float() for m, w in ((ctx["saa"], w_aa), (ctx["s3d"], w_3di))]
    ql, tl = args[4].long().clamp(0, args[0].shape[1]), args[5].long()
    rows = torch.arange(args[0].shape[1], device=ql.device)[None, :] < ql[:, None]
    if all(bool((t == t.round()).all()) for t in tabs):
        room = I16_FAST_MAX - sum(float(t.abs().max()) for t in tabs)
        bias = torch.zeros_like(rows, dtype=torch.float32) if qc is None else qc.float().to(torch.bfloat16).float()
        fast = rows & (bias.abs() <= room)
    else:
        fast = torch.zeros_like(rows)
    fast_cells = float((fast.sum(1).double() * tl.double()).sum())
    other_cells = cells_of(args) - fast_cells
    cycles = sum(cells / 64 * (I16_PACKED_PER_WORD[kind] / I16_PACKED_RATE
                               + I16_SCORE_PER_WORD[f] / ISSUE_LIMIT)
                 for f, cells in ((True, fast_cells), (False, other_cells)))
    ops_ms = cycles / (ctx["peak_ops"] / LANES_PER_SM) * 1e3  # peak_ops / 128: SMs x the SM clock
    bytes_ms = bytes_of(args, qc) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def bound_of(ctx, args, qc, kind):
    """(bound_ms, ops_ms, bytes_ms) of one launch on these inputs."""
    ops_ms = cells_of(args) * (OPS_PER_CELL[kind] + 1) / ctx["peak_ops"] * 1e3
    bytes_ms = bytes_of(args, qc) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def time_cuda(fn, n):
    """ms per call of `fn`: CUDA events around n back-to-back calls, after
    two warm-up calls.  The calls are queued behind a spin of the card
    (torch.cuda._sleep) of twice the host's time to enqueue them (the
    second warm-up's host time, times n) plus 1 ms, so the events enclose
    launches that are already queued and a slow host adds no gaps between
    them.  Where the n calls take the host more than SPIN_MAX_S (the plain
    versions' row loops of many small launches, which no queue holds) there
    is no spin, and the reading includes the host's gaps, as a call that
    waits on the card (none of the wrappers does) reads either way."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = (time.perf_counter() - t0) * n
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if 2 * enqueue_s + 1e-3 <= SPIN_MAX_S:
        torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * SPIN_CYCLES_PER_S))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def once_ms(fn):
    """ms of one call of `fn` on the host's clock, synchronised on both
    sides: for the plain versions, whose PyTorch ops earlier phases have
    already run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


_RUNNING = set()  # CLI subprocesses in flight, killed by stop_cli_runs()
_RUNNING_LOCK = threading.Lock()
_STOPPED = threading.Event()


def stop_cli_runs():
    """Kill every CLI subprocess in flight and start no more."""
    with _RUNNING_LOCK:
        _STOPPED.set()
        for proc in _RUNNING:
            proc.kill()


def run_steps(steps, out_dir, home, device=None, threads=None, one_process=False):
    """Run `python -m unicore_tpu_torch` steps [(name, argv)] (or `python
    -c` steps, argv ["-c", code]), each a subprocess with HOME=home (and
    `threads` torch threads, if given); returns ({name: seconds},
    {name: counters}).  With `one_process`, CLI steps only: all of them
    in one subprocess, one after the other (cli_chain), which pays the
    interpreter's, torch's and the card's start-up once; their seconds
    are then the CLI calls' own."""
    if one_process and steps:
        chain = steps[0][0] + "_chain"
        code = f"import chip_smoke as c; c.cli_chain({list(steps)!r}, {out_dir!r}, {chain!r})"
        run_steps([(chain, ["-c", code])], out_dir, home, device, threads)
        times = json.load(open(os.path.join(out_dir, f"{chain}.times.json")))
        return times, {k: json.load(open(os.path.join(out_dir, f"{k}.counters.json"))) for k in times}
    env = dict(os.environ, HOME=home, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("UNICORE_TPU_TORCH_DEVICE", None)
    if device:
        env["UNICORE_TPU_TORCH_DEVICE"] = device
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    os.makedirs(out_dir, exist_ok=True)
    times, counters = {}, {}
    for stage, argv in steps:
        cfile = os.path.join(out_dir, f"{stage}.counters.json")
        env["UNICORE_TPU_TORCH_COUNTERS"] = cfile
        t0 = time.perf_counter()
        with _RUNNING_LOCK:
            if _STOPPED.is_set():
                raise SmokeError(f"{stage} not started: the run is stopping")
            cmd = argv if argv[0] == "-c" else ["-m", "unicore_tpu_torch", *argv, "-v", "2"]
            proc = subprocess.Popen([sys.executable, *cmd], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            _RUNNING.add(proc)
        try:
            out, err = proc.communicate()
        finally:
            _RUNNING.discard(proc)
        times[stage] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeError(f"{stage} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
        counters[stage] = json.load(open(cfile))
    return times, counters


def cli_chain(steps, out_dir, chain):
    """`unicore_tpu_torch.cli.main` on each of `steps` [(name, argv)] in
    this process, one after the other, each with its counters and kernel
    launches counted from 0 and written where run_steps reads them; the
    seconds of each call go to {chain}.times.json and the chain's own
    (empty) counters to {chain}.counters.json."""
    from unicore_tpu_torch.cli import main
    from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
    from unicore_tpu_torch.runtime import profiling

    times = {}
    for stage, argv in steps:
        profiling.reset_counters()
        sw_cuda.reset_launch_counts()
        banded_cuda.reset_launch_counts()
        dirbits_cuda.reset_launch_counts()
        os.environ["UNICORE_TPU_TORCH_COUNTERS"] = os.path.join(out_dir, f"{stage}.counters.json")
        t0 = time.perf_counter()
        rc = main([*argv, "-v", "2"])
        times[stage] = time.perf_counter() - t0
        if rc != 0:
            sys.exit(f"{stage} exited {rc}")
    with open(os.path.join(out_dir, f"{chain}.times.json"), "w") as f:
        json.dump(times, f)
    profiling.reset_counters()
    profiling.dump(os.path.join(out_dir, f"{chain}.counters.json"), {})


def run_slice(in_dir, out_dir, home, device=None, one_process=False, inference=False):
    """createdb -> cluster -> profile -> tree -n through the CLI, then with
    `inference` `tree` again (the skip path: inference alone); each step a
    subprocess, or with `one_process` all in one (cli_chain), as easy-core
    runs its stages."""
    db = os.path.join(out_dir, "proteome", "proteome_db")
    steps = [
        ("createdb", ["createdb", in_dir, db, "mock"]),
        ("cluster", ["cluster", db, os.path.join(out_dir, "cluster", "clust"),
                     os.path.join(out_dir, "tmp")]),
        ("profile", ["profile", db, os.path.join(out_dir, "cluster", "clust.tsv"),
                     os.path.join(out_dir, "profile")]),
        ("tree", ["tree", db, os.path.join(out_dir, "profile"), os.path.join(out_dir, "tree"), "-n"]),
    ]
    if inference:
        steps.append(("tree_inference", ["tree", db, os.path.join(out_dir, "profile"), os.path.join(out_dir, "tree")]))
    return run_steps(steps, out_dir, home, device, one_process=one_process)


def run_easy_core(in_dir, out_dir, home, device, threads, beside, sides):
    """easy-core with its defaults, then the tree runs on its database, core
    genes and copies of its supermatrix: tree -n with the two other
    aligners, tree -T fasttree and tree -T raxml-ng, with other steps.
    `beside`: steps run next to easy-core, on a third of the threads;
    `sides(trees)`: lists of steps made once easy-core has ended from
    `trees`, {name: step} of those four tree runs; each list runs in order
    in one process (run_steps' `one_process`), the lists side by side,
    each on an equal share of the threads."""
    db = os.path.join(out_dir, "proteome", "proteome_db")
    prof = os.path.join(out_dir, "profile")
    third = threads and max(1, threads // 3) if beside else 0
    with ThreadPoolExecutor(1) as pool:
        next_to = pool.submit(run_steps, list(beside), out_dir, home, device, third)
        times, counters = run_steps(
            [("easy-core", ["easy-core", in_dir, out_dir, "mock", os.path.join(out_dir, "tmp")])],
            out_dir, home, device, threads and threads - third)
        beside_times, beside_counters = next_to.result()
    times.update(beside_times)
    counters.update(beside_counters)
    for sub in ("tree_fasttree", "tree_raxml"):
        os.makedirs(os.path.join(out_dir, sub))
        for f in ("combined.fasta", "combined.fasta.partitions"):
            shutil.copy(os.path.join(out_dir, "tree", f), os.path.join(out_dir, sub, f))
    trees = {name: (name, ["tree", db, prof, os.path.join(out_dir, name), *opts]) for name, opts in (
        ("tree_mafft", ["-n", "-A", "mafft"]), ("tree_linsi", ["-n", "-A", "mafft-linsi"]),
        ("tree_fasttree", ["-T", "fasttree"]), ("tree_raxml", ["-T", "raxml-ng"]))}
    lists = sides(trees)
    share = threads and max(1, threads // len(lists))
    with ThreadPoolExecutor(len(lists)) as pool:
        for side_times, side_counters in pool.map(
                lambda steps: run_steps(steps, out_dir, home, device, share, one_process=True), lists):
            times.update(side_times)
            counters.update(side_counters)
    return times, counters


def check_tree(out_dir, n_species):
    """The tree stage's outputs: a filtered MSA for every core gene, whose
    rows ungapped are the gene's input sequences, and a supermatrix with
    one row per species whose partitions tile its width.  Returns
    (genes, supermatrix width, partitions)."""
    from unicore_tpu_torch.io.fasta import read_fasta

    tree = os.path.join(out_dir, "tree")
    genes = sorted(n[:-4] for n in os.listdir(os.path.join(out_dir, "profile")) if n.endswith(".txt"))
    check(len(genes) > 0, "no core genes")
    for g in genes:
        gdir = os.path.join(tree, "fasta", g)
        check(os.path.isfile(os.path.join(gdir, f"{g}.fa.filtered")), f"core gene {g} has no filtered MSA")
        msa = read_fasta(os.path.join(gdir, f"{g}_aa.fa"))
        check(len({len(r) for r in msa.values()}) == 1, f"rows of {g}_aa.fa differ in length")
        check({k: r.replace("-", "") for k, r in msa.items()} == read_fasta(os.path.join(gdir, "aa.fasta")),
              f"rows of {g}_aa.fa, ungapped, are not the gene's input sequences")
    combined = read_fasta(os.path.join(tree, "combined.fasta"))
    widths = {len(r) for r in combined.values()}
    check(len(widths) == 1, f"combined.fasta rows differ in length: {sorted(widths)}")
    check(len(combined) == n_species, f"combined.fasta has {len(combined)} rows for {n_species} species")
    width = widths.pop()
    parts = [line.rsplit("=", 1)[1].split("-") for line in
             open(os.path.join(tree, "combined.fasta.partitions")).read().splitlines()]
    pos = 1
    for a, b in parts:
        check(int(a) == pos and int(b) >= pos - 1, f"partition {a}-{b} does not start at column {pos}")
        pos = int(b) + 1
    check(pos == width + 1 and len(parts) == len(genes),
          f"{len(parts)} partitions end at column {pos - 1}; width {width}, {len(genes)} core genes")
    return genes, width, len(parts)


TREE_FILES = ("iqtree.treefile", "fasttree.nwk", "raxml-ng.raxml.bestTree", "raxml-ng.raxml.support")
REPORT_FILES = ("iqtree.iqtree", "iqtree.log")


def tree_edges(text):
    """{split: (length, support)} of a Newick tree, leaf edges included; a
    split is its smaller side (ties: the sorted-first)."""
    from unicore_tpu_torch.phylo.newick import parse_newick

    tree = parse_newick(text)
    everyone = frozenset(x.name for x in tree.leaves())
    out = {}
    for node in tree.postorder():
        if node is not tree:
            below = frozenset(x.name for x in node.leaves())
            out[min(below, everyone - below, key=lambda s: (len(s), sorted(s)))] = (node.length, node.support)
    return out


def unlabelled_splits(edges):
    """Internal splits without a support.  At most one is allowed: the JAX
    package, and the port with it, leaves the root split of the rooted
    search tree unlabelled when both root children are internal."""
    return [k for k, (_, sup) in edges.items() if len(k) > 1 and sup is None]


def check_same_tree(ref, got, what, supported):
    """The CUDA tree `got` against the CPU tree `ref`: the same splits (RF
    0), lengths within BLEN_ATOL + BLEN_RTOL len; with `supported`, at most
    one unlabelled internal split in each, and every support both write
    in [0, 100] and within SUPPORT_POINTS."""
    from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance

    rf = rf_distance(parse_newick(ref), parse_newick(got))
    a, b = tree_edges(ref), tree_edges(got)
    check(rf == 0 and set(a) == set(b), f"{what}: RF {rf} between the CUDA and CPU trees")
    if supported:
        check(max(len(unlabelled_splits(a)), len(unlabelled_splits(b))) <= 1,
              f"{what}: internal splits without a support: {unlabelled_splits(a)}, {unlabelled_splits(b)}")
    for k in a:
        (la, sa), (lb, sb) = a[k], b[k]
        check(abs(lb - la) <= BLEN_ATOL + BLEN_RTOL * la, f"{what}: branch {sorted(k)} {la} vs {lb}")
        if supported and len(k) > 1 and sa is not None and sb is not None:
            check(0.0 <= sb <= 100.0 and abs(sb - sa) <= SUPPORT_POINTS,
                  f"{what}: split {sorted(k)} support {sa} vs {sb}")


def report_lines(data):
    return dict(line.split(": ", 1) for line in data.decode().splitlines() if ": " in line)


def check_same_files(a, b):
    """CUDA files `b` against CPU files `a`: the same names, inference
    outputs compared after parsing, every other file byte-identical.
    Returns the number of inference outputs compared."""
    check(sorted(a) == sorted(b), f"file sets differ: {sorted(set(a) ^ set(b))}")
    n_inf = 0
    for name in sorted(a):
        base = os.path.basename(name)
        if base in TREE_FILES:
            check_same_tree(a[name].decode(), b[name].decode(), name, not base.endswith("bestTree"))
        elif base in REPORT_FILES:
            ra, rb = report_lines(a[name]), report_lines(b[name])
            la, lb = float(ra.pop("lnL")), float(rb.pop("lnL"))
            check(abs(lb - la) <= BLEN_LL_RTOL * abs(la), f"{name}: lnL {la} vs {lb}")
            ra.pop("seconds"), rb.pop("seconds")
            check(ra == rb, f"{name}: report lines differ: {ra} vs {rb}")
        else:
            check(a[name] == b[name], f"CUDA and CPU outputs differ: {name}")
            continue
        n_inf += 1
    return n_inf


def read_files(root, skip=(".counters.json", ".times.json")):
    out = {}
    for d, _, names in os.walk(root):
        if os.path.relpath(d, root).split(os.sep)[0] == "tmp":
            continue
        for n in names:
            if not n.endswith(skip):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def host_cpu():
    """The host CPU's model, core count and the vector extensions that
    select the CPU kernels (phase 3c's and 5's CPU sides run on them)."""
    info = open("/proc/cpuinfo").read()
    model = next((l.split(":", 1)[1].strip() for l in info.splitlines() if l.startswith("model name")), "unknown")
    flags = set(next((l.split(":", 1)[1].split() for l in info.splitlines() if l.startswith("flags")), []))
    ext = [f for f in ("avx2", "avx512f", "avx512_bf16", "amx_bf16", "amx_tile") if f in flags]
    return f"{model}, {os.cpu_count()} cores, {' '.join(ext) or 'no avx2'}"


def _built(mod):
    """mod.build(), its span on the script's clock in lane "nvcc"."""
    with span(f"phase 1, nvcc {os.path.basename(mod.SOURCE)}", lane="nvcc"):
        return mod.build()


def phase_env():
    """Phase 1: the card, the versions, the kernel's build; returns the
    context the other phases share."""
    import torch

    from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
    from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    peak_ops = props.multi_processor_count * LANES_PER_SM * float(clock) * 1e6
    log(smi)
    card_id = subprocess.run(["nvidia-smi", "--query-gpu=uuid,pci.bus_id", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    log(f"card {card_id}; kernel {platform.release()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {props.name}, "
        f"{props.multi_processor_count} SMs, max SM clock {clock} MHz, "
        f"peak scalar rate {peak_ops / 1e12:.2f} Tops/s")
    log(f"host: {host_cpu()}; torch CPU kernels {torch.backends.cpu.get_cpu_capability()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
        builds = [(mod, pool.submit(_built, mod)) for mod in (sw_cuda, banded_cuda, dirbits_cuda)]
        for mod, fut in builds:
            log(f"[phase 1] kernel built from {os.path.relpath(mod.SOURCE, ROOT)} in {fut.result():.1f} s")
    log(f"[phase 1] the three kernels built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    saa_np = get_aa_matrix().astype(np.float32)
    s3d_np = get_3di_matrix().astype(np.float32)
    return dict(dev=dev, peak_ops=peak_ops, saa_np=saa_np, s3d_np=s3d_np, smi=smi,
                saa=torch.from_numpy(saa_np).to(dev), s3d=torch.from_numpy(s3d_np).to(dev),
                rng=np.random.RandomState(20261016))


def phase_exact(ctx):
    """Phase 2: kernel vs plain version, bit-exact; returns the largest
    |best| difference per mode (0 when exact)."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain
    from unicore_tpu_torch.synthetic import SW_EDGE_CASES, sw_edge_pairs

    saa, s3d = ctx["saa"], ctx["s3d"]
    max_err = {"gapped": 0.0, "ungapped": 0.0}
    n_cmp = 0
    t0 = time.perf_counter()
    for s, (B, L) in enumerate(EXACT_SHAPES):
        for bi, bias in enumerate(("off", "on", "clip")):
            args, qc = sw_inputs(ctx["rng"], B, L, bias, ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
            settings = [(mode, kw, go, ge) for mode, kw in MODES.items()
                        for go, ge in (GAPS if mode != "ungapped" else GAPS[:1])]
            # half the settings per shape and bias, the other half on the next
            for mode, kw, go, ge in settings[(s + bi) % 2::2]:
                k = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw)
                p = sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw)
                torch.cuda.synchronize()
                kind = "ungapped" if mode == "ungapped" else "gapped"
                err = float((k[0] - p[0]).abs().max())
                max_err[kind] = max(max_err[kind], err)
                ok = all(torch.equal(a, b) for a, b in zip(k, p))
                check(ok, f"kernel != plain at B={B} L={L} {mode} bias={bias} go/ge={go}/{ge}: "
                          f"max |best| err {err}, qend diff {int((k[1] != p[1]).sum())}, "
                          f"tend diff {int((k[2] != p[2]).sum())}")
                n_cmp += 1
    dev = ctx["dev"]
    for s, (B, Lq, Lt) in enumerate(EDGE_SHAPES):
        modes = [dict(gap_window=w) for w in EDGE_WINDOWS + [Lt, 2 * Lt]] + [dict(ungapped=True)]
        for n, kw in enumerate(modes):
            if (n + s) % 2:  # half the settings per shape, the other half on the next
                continue
            case = SW_EDGE_CASES[(n + Lt) % len(SW_EDGE_CASES)]
            arrays, go, ge = sw_edge_pairs(ctx["rng"], case, B, Lq, Lt)
            t = [torch.from_numpy(x).to(dev) for x in arrays]
            k = sw_cuda.sw_forward_cuda(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            p = sw_forward_plain(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            torch.cuda.synchronize()
            kind = "ungapped" if kw.get("ungapped") else "gapped"
            err = float((k[0] - p[0]).abs().max())
            max_err[kind] = max(max_err[kind], err)
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"kernel != plain at B={B} Lq={Lq} Lt={Lt} {kw} case={case}: max |best| err {err}, "
                  f"qend diff {int((k[1] != p[1]).sum())}, tend diff {int((k[2] != p[2]).sum())}")
            n_cmp += 1
    log(f"[phase 2] {n_cmp} kernel-vs-plain comparisons bit-exact on (best, qend, tend) "
        f"in {time.perf_counter() - t0:.1f} s")
    return max_err


def band_pairs_on(arrays, dev):
    import torch

    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]


def phase_banded_exact(ctx):
    """Phase 2b: the banded kernel (csrc/banded.cu) vs its plain version
    (ops/banded.py::sw_forward_banded) on the card, bit-exact on (best,
    qend, tend): BANDED_GRID x every case of synthetic.banded_edge_pairs
    (seed diagonals planted, partly outside, off the end and wholly
    outside; ties, a gap bonus, a negative gap extend, |qc| past 2^24,
    lengths of 1), two of the three modes (gap_window 64, 0, ungapped)
    each, bias off on every other one, and gaps 28/3 on the ragged case;
    the windows of BANDED_WINDOWS at one, four and eight warps a pair; the
    engine's full batches (BANDED_ENGINE) in both engine modes; the edges
    of the kernel's table (BANDED_CLASS_EDGES) and a batch of
    BANDED_OVER_CAP pairs, both engine modes; the widest band, and one
    past it refused.  Returns the largest |best|
    difference per mode (0 when exact)."""
    import torch

    from unicore_tpu_torch.ops import banded_cuda
    from unicore_tpu_torch.ops.banded import sw_forward_banded
    from unicore_tpu_torch.synthetic import BANDED_EDGE_CASES, banded_edge_pairs

    dev, saa, s3d = ctx["dev"], ctx["saa"], ctx["s3d"]
    max_err = {"gapped": 0.0, "ungapped": 0.0}
    n_cmp = 0
    t0 = time.perf_counter()

    def held(arrays, kw, what):
        nonlocal n_cmp
        t = band_pairs_on(arrays, dev)
        k = banded_cuda.sw_forward_banded_cuda(*t[:7], saa, s3d, qc=t[7], **kw)
        p = sw_forward_banded(*t[:7], saa, s3d, qc=t[7], **kw)
        torch.cuda.synchronize()
        kind = "ungapped" if kw.get("ungapped") else "gapped"
        err = float((k[0] - p[0]).abs().max())
        max_err[kind] = max(max_err[kind], err)
        check(all(torch.equal(a, b) for a, b in zip(k, p)),
              f"2b: banded kernel != plain at {what} {kw}: max |best| err {err}, qend diff "
              f"{int((k[1] != p[1]).sum())}, tend diff {int((k[2] != p[2]).sum())}")
        n_cmp += 1
        return k

    modes = [dict(gap_window=64), dict(gap_window=0), dict(ungapped=True)]
    for s, (B, Lq, Lt, W) in enumerate(BANDED_GRID):
        for n, case in enumerate(BANDED_EDGE_CASES):
            arrays, go, ge = banded_edge_pairs(ctx["rng"], case, B, Lq, Lt, W)
            if (s + n) % 2:
                arrays = (*arrays[:7], None)
            for m in ((s + n) % 3, (s + n + 1) % 3):
                held(arrays, dict(W=W, go=go, ge=ge, **modes[m]), f"B={B} Lq={Lq} Lt={Lt} case={case}")
            if case == "ragged":
                held(arrays, dict(W=W, go=28.0, ge=3.0, gap_window=64), f"B={B} Lq={Lq} Lt={Lt} 28/3")
    for window in BANDED_WINDOWS:
        for B, Lq, Lt, W in ((8, 200, 300, 256), (4, 150, 2100, 2048), (2, 60, 4200, 4096)):
            arrays, go, ge = banded_edge_pairs(ctx["rng"], "neg_ge" if window % 2 else "ragged", B, Lq, Lt, W)
            held(arrays, dict(W=W, go=go, ge=ge, gap_window=window), f"B={B} Lq={Lq} Lt={Lt}")
    for B, Lq, Lt, W in BANDED_ENGINE:
        arrays = _band_pairs(ctx["rng"], B, Lq, Lt)
        for kw in (dict(gap_window=64), dict(ungapped=True)):
            best = held(arrays, dict(W=W, **kw), f"the engine's batch B={B} Lq={Lq} Lt={Lt}")[0]
            check(float(best.min()) > 0, f"2b: a planted pair scored 0 at B={B} Lq={Lq} W={W}")
    for W in BANDED_CLASS_EDGES:
        arrays, go, ge = banded_edge_pairs(ctx["rng"], "ragged", 6, 300, W + 300, W)
        for kw in (dict(gap_window=64), dict(ungapped=True)):
            held(arrays, dict(W=W, go=go, ge=ge, **kw), f"the table's edge W={W}")
    B, Lq, Lt, W = BANDED_OVER_CAP
    arrays = _band_pairs(ctx["rng"], B, Lq, Lt)
    for kw in (dict(gap_window=64), dict(ungapped=True)):
        best = held(arrays, dict(W=W, **kw), f"a batch of {B} pairs above the old cap")[0]
        check(float(best.min()) > 0, f"2b: a planted pair scored 0 in the batch of {B}")
    W = banded_cuda.MAX_W
    arrays, go, ge = banded_edge_pairs(ctx["rng"], "ragged", 4, 48, W + 100, W)
    for kw in modes:
        held(arrays, dict(W=W, go=go, ge=ge, **kw), "the widest band")
    t = band_pairs_on(arrays, dev)
    try:
        banded_cuda.sw_forward_banded_cuda(*t[:7], saa, s3d, W=W + 1)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"2b: a band of W = {W + 1} was not refused")
    log(f"[phase 2b] {n_cmp} banded kernel-vs-plain comparisons bit-exact on (best, qend, tend), W up to "
        f"{W} (W = {W + 1} refused), in {time.perf_counter() - t0:.1f} s")
    return max_err


def phase_dirbits_exact(ctx):
    """Phase 2c: both instances of the direction-bit kernel against their
    plain versions on the card, bit-identical on whole (B, L1, L2) bits
    arrays and on (end_i, end_j, score): DIRBITS_GAPS x DIRBITS_GRID x
    every kind of synthetic.dirbits_scores x int16 and int32 S; the
    callers' full batches (DIRBITS_FULL) on every kind of their own
    generators (nw_scores, sw_windows), S and the gaps alternating; the
    rows past one tile (DIRBITS_WIDE); each row-width class's edge and one
    past it (DIRBITS_CLASSES) with one scan a row and with two.  Returns
    the largest |score| difference per instance (0 when exact)."""
    import torch

    from unicore_tpu_torch.ops import dirbits_cuda, nw_device, sw_bits
    from unicore_tpu_torch.synthetic import (
        DIRBITS_KINDS, NW_SCORE_KINDS, SW_WINDOW_KINDS, dirbits_scores, nw_scores, sw_windows,
    )

    fns = {"nw": (dirbits_cuda.nw_forward_bits_cuda, nw_device.nw_forward_bits),
           "sw_bits": (dirbits_cuda.sw_forward_bits_cuda, sw_bits.sw_forward_bits)}
    rng, dev = ctx["rng"], ctx["dev"]
    max_err = {kind: 0 for kind in fns}
    n_cmp = 0
    t0 = time.perf_counter()

    def held(kind, arrays, go, ge, what):
        nonlocal n_cmp
        kernel, plain = fns[kind]
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]
        k, p = kernel(*t, go, ge), plain(*t, go, ge)
        torch.cuda.synchronize()
        max_err[kind] = max(max_err[kind], int((k[3] - p[3]).abs().max()))
        for name, a, b in zip(("bits", "end_i", "end_j", "score"), k, p):
            check(torch.equal(a, b), f"2c: {kind} kernel != plain in {name} at {what}, S {arrays[0].dtype}, "
                                     f"go/ge {go}/{ge}: {int((a != b).sum())} differ")
        n_cmp += 1

    for kind in fns:
        for go, ge in DIRBITS_GAPS:
            for shape in DIRBITS_GRID:
                for sk in DIRBITS_KINDS:
                    for dtype in (np.int16, np.int32):
                        held(kind, dirbits_scores(rng, *shape, sk, dtype), go, ge, f"{shape} {sk}")
        kinds = NW_SCORE_KINDS if kind == "nw" else SW_WINDOW_KINDS
        caller = DIRBITS_GAPS[0] if kind == "nw" else DIRBITS_GAPS[2]
        for n, (B, Lb) in enumerate(DIRBITS_FULL[kind]):
            for m, sk in enumerate(kinds):
                S, l1, l2 = nw_scores(rng, B, Lb, Lb, sk) if kind == "nw" else sw_windows(rng, B, Lb, sk)
                go, ge = (caller, DIRBITS_GAPS[3], DIRBITS_GAPS[4])[m]
                held(kind, (S.astype(np.int32) if (n + m) % 2 else S, l1, l2), go, ge, f"({B}, {Lb}, {Lb}) {sk}")
        for n, shape in enumerate(DIRBITS_WIDE):
            for m, sk in enumerate(DIRBITS_KINDS):
                dtype = (np.int16, np.int32)[(n + m) % 2]
                held(kind, dirbits_scores(rng, *shape, sk, dtype), *caller, f"{shape} {sk}")
        for n, L2 in enumerate(w + d for w in DIRBITS_CLASSES for d in (0, 1)):
            for m, gaps in enumerate((caller, DIRBITS_GAPS[4])):  # one scan a row, two
                dtype = (np.int16, np.int32)[(n + m) % 2]
                held(kind, dirbits_scores(rng, *DIRBITS_EDGE_BATCH, L2, DIRBITS_KINDS[m], dtype), *gaps,
                     f"{(*DIRBITS_EDGE_BATCH, L2)} class edge, C {dirbits_cuda.columns_of(L2)}")
    log(f"[phase 2c] {n_cmp} direction-bit kernel-vs-plain comparisons (NW and SW) bit-identical on whole bits "
        f"arrays and (end_i, end_j, score), rows up to {max(s[2] for s in DIRBITS_WIDE)} columns, the table's "
        f"class edges, one scan and two scans a row, in {time.perf_counter() - t0:.1f} s")
    return max_err


def dirbits_bound(ctx, S, kind):
    """(bound_ms, ops_ms, bytes_ms) of one direction-bit launch on S (B,
    L1, L2): every cell at DIRBITS_OPS_PER_CELL over the peak scalar rate;
    S, the lengths and the outputs (a byte of bits a cell, three int32 a
    pair) read or written once over HBM_BYTES_PER_S."""
    cells = float(S.numel())
    ops_ms = cells * DIRBITS_OPS_PER_CELL[kind] / ctx["peak_ops"] * 1e3
    bytes_ms = (cells * S.element_size() + cells + 5 * 4 * S.shape[0]) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def banded_bound(ctx, t, W, kind):
    """(bound_ms, ops_ms, bytes_ms) of one banded launch on these inputs:
    sum(qlen * W) band cells at OPS_PER_CELL (+1 for the bias add) over the
    peak scalar rate; every input read once and every output written once
    over HBM_BYTES_PER_S."""
    Lq = t[0].shape[1]
    cells = float(t[4].clamp(0, Lq).double().sum()) * W
    ops_ms = cells * (OPS_PER_CELL[kind] + (t[7] is not None)) / ctx["peak_ops"] * 1e3
    nbytes = sum(x.numel() * x.element_size() for x in t if x is not None) + 2 * 21 * 21 * 4 + t[0].shape[0] * 12
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def phase_banded_times(ctx, reps=20):
    """Phase 3e: the banded kernel per mode (the engine's: gap_window 64,
    ungapped; bias on) at the engine's full batches (BANDED_ENGINE): kernel
    ms (CUDA events over `reps` launches after a warm-up), the plain
    version's ms on the card (one call), and the bound; returns {kind:
    numbers} at BANDED_TIMED."""
    from unicore_tpu_torch.ops import banded_cuda
    from unicore_tpu_torch.ops.banded import sw_forward_banded

    saa, s3d = ctx["saa"], ctx["s3d"]
    log(f"[phase 3e] banded SW, B Lq Lt W mode | kernel ms | us per row | plain ms | bound ms (ops, bytes) | "
        f"share of bound ({ctx['smi']})")
    timing = {}
    for B, Lq, Lt, W in BANDED_ENGINE:
        t = band_pairs_on(_band_pairs(ctx["rng"], B, Lq, Lt), ctx["dev"])
        for kind, kw in TIMED_MODES.items():
            ms = time_cuda(lambda: banded_cuda.sw_forward_banded_cuda(*t[:7], saa, s3d, W=W, qc=t[7], **kw), reps)
            plain_ms = once_ms(lambda: sw_forward_banded(*t[:7], saa, s3d, W=W, qc=t[7], **kw))
            bound_ms, ops_ms, bytes_ms = banded_bound(ctx, t, W, kind)
            if (B, Lq, Lt, W) == BANDED_TIMED:
                timing[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by="operations" if ops_ms >= bytes_ms else "bytes")
            log(f"  {B:3d} {Lq:5d} {Lt:5d} {W:5d} {kind:8s} | {ms:9.4f} | {1e3 * ms / Lq:7.4f} | {plain_ms:9.2f} | "
                f"{bound_ms:.4f} ({ops_ms:.4f}, {bytes_ms:.5f}) | {100 * bound_ms / ms:.2f} %")
    phase_banded_sweep(ctx)
    return timing


def phase_banded_sweep(ctx, reps=5):
    """3e's sweep: every candidate C of each band-width class of
    BANDED_SWEEP at the class's batches, per engine mode, bit-equal to the
    table's launch and timed (CUDA events over `reps` launches); prints
    ms per batch and their sum, the fastest C and the table's."""
    import torch

    from unicore_tpu_torch.ops import banded_cuda

    saa, s3d = ctx["saa"], ctx["s3d"]
    log(f"[phase 3e] sweep of the banded kernel's columns a lane: class W, mode | C warps | ms per batch "
        f"(B x Lq x Lt at W) | sum ({ctx['smi']})")
    batches = {key: [(shape, band_pairs_on(_band_pairs(ctx["rng"], *shape[:3]), ctx["dev"])) for shape in shapes]
               for key, shapes in BANDED_SWEEP.items()}
    for cls, shapes in batches.items():
        for kind, kw in TIMED_MODES.items():
            rows = []
            for C in BANDED_SWEEP_COLUMNS[cls]:
                per = []
                for (B, Lq, Lt, W), t in shapes:
                    def call():
                        return banded_cuda.sw_forward_banded_columns(C, *t[:7], saa, s3d, W=W, qc=t[7], **kw)
                    ref = banded_cuda.sw_forward_banded_cuda(*t[:7], saa, s3d, W=W, qc=t[7], **kw)
                    check(all(torch.equal(a, b) for a, b in zip(ref, call())),
                          f"3e: C {C} != the table's at {(B, Lq, Lt, W)} {kind}")
                    per.append(time_cuda(call, reps))
                rows.append((C, -(-cls // (32 * C)), sum(per)))
                log(f"  {cls:5d} {kind:8s} | C {C:2d} warps {rows[-1][1]:2d} | "
                    + ", ".join(f"{ms:.4f}" for ms in per) + f" | {sum(per):.4f}")
            best = min(rows, key=lambda r: r[2])
            log(f"  {cls:5d} {kind:8s} | fastest C {best[0]} warps {best[1]}; the table's C "
                f"{banded_cuda.columns_of(cls, kind == 'ungapped')}")


def phase_times(ctx, shapes=SHAPES, reps=50, plain_reps=2):
    """Phase 3: times per shape and mode, with the engine's settings
    (gap_window 64, bias on), the plain version's over `plain_reps` calls
    at KERNEL_SHAPE (time_cuda) and one call elsewhere (once_ms); returns
    {(B, L, kind): numbers}."""
    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain

    saa, s3d = ctx["saa"], ctx["s3d"]
    log("[phase 3] B L mode | kernel ms GCUPS | plain ms | bound ms (ops, bytes) | share of bound")
    timing = {}
    for B, L in shapes:
        args, qc = sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
        cells = cells_of(args)
        for kind, kw in TIMED_MODES.items():
            ms = time_cuda(lambda: sw_cuda.sw_forward_cuda(*args, saa, s3d, qc=qc, **kw), reps)
            def plain():
                return sw_forward_plain(*args, saa, s3d, qc=qc, **kw)
            plain_ms = time_cuda(plain, plain_reps) if (B, L) == KERNEL_SHAPE else once_ms(plain)
            bound_ms, ops_ms, bytes_ms = bound_of(ctx, args, qc, kind)
            timing[(B, L, kind)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", gcups=cells / ms / 1e6)
            log(f"  {B:4d} {L:5d} {kind:8s} | {ms:9.4f} {cells / ms / 1e6:7.1f} | "
                f"{plain_ms:9.2f} | {bound_ms:.4f} ({ops_ms:.4f}, {bytes_ms:.5f}) | "
                f"{100 * bound_ms / ms:.1f} %")
    return timing


def i16_inputs(ctx, B, L, bias):
    """sw_inputs' pairs; every fourth a self pair, which reaches the cap
    (gapped) or wraps (ungapped) from about 500 columns on, its rows at
    +255 with bias on: cells past the int16 contract's < 150 assumption."""
    args, qc = sw_inputs(ctx["rng"], B, L, bias, ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
    hot = slice(1, B, 4)
    args[2][hot], args[3][hot], args[5][hot] = args[0][hot], args[1][hot], args[4][hot]
    if qc is not None:
        qc[hot] = 255
    return args, qc


def i16_seam_inputs(ctx, B, Lq, Lt):
    """Ragged pairs whose targets end anywhere, half of them past Lt/2 (the
    fold of a one-warp block), every fourth a self pair with +255 on every
    other such pair's rows; bias on."""
    import torch

    rng = ctx["rng"]
    qa, qs = (rng.randint(0, 20, (B, Lq)).astype(np.int32) for _ in range(2))
    ta, ts = (rng.randint(0, 20, (B, Lt)).astype(np.int32) for _ in range(2))
    ql = rng.randint(1, Lq + 1, B).astype(np.int32)
    tl = rng.randint(1, Lt + 1, B).astype(np.int32)
    tl[::2] = rng.randint(Lt // 2, Lt + 1, len(tl[::2]))
    hot = np.arange(3, B, 4)
    n = min(Lq, Lt)
    ta[hot, :n], ts[hot, :n] = qa[hot, :n], qs[hot, :n]
    qc = rng.randint(-60, 40, (B, Lq)).astype(np.int32)
    qc[hot[::2]] = 255
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(ctx["dev"])  # noqa: E731
    return [t(x) for x in (qa, qs, ta, ts, ql, tl)], t(qc)


def phase_i16_exact(ctx):
    """Phase 2d: the int16 instance vs the plain int16 DP, bit-exact;
    the 512 self pair's cap and wrap; the int16 instance equal to the
    float32 one on every pair below the cap; the shapes across its fold
    (I16_SEAM).  Returns the largest |best|
    difference per mode."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain

    saa, s3d, dev = ctx["saa"], ctx["s3d"], ctx["dev"]
    max_err = {"gapped_i16": 0.0, "ungapped_i16": 0.0}
    n_cmp = n_f32 = 0
    t0 = time.perf_counter()
    modes = list(I16_MODES.items())
    for s, (B, L, go, ge) in enumerate(I16_SHAPES):
        for bi, bias in enumerate(("off", "on")):
            args, qc = i16_inputs(ctx, B, L, bias)
            for mode, kw in modes[(s + bi) % 2::2]:  # every mode on every shape
                k = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **kw)
                p = sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **kw)
                torch.cuda.synchronize()
                kind = "ungapped_i16" if mode == "ungapped" else "gapped_i16"
                err = float((k[0] - p[0]).abs().max())
                max_err[kind] = max(max_err[kind], err)
                check(all(torch.equal(a, b) for a, b in zip(k, p)),
                      f"int16 kernel != plain at B={B} L={L} {mode} bias={bias}: max |best| err {err}, "
                      f"qend diff {int((k[1] != p[1]).sum())}, tend diff {int((k[2] != p[2]).sum())}")
                n_cmp += 1
        # below the cap the int16 DP is the float32 one
        args, qc = sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], dev)
        for mode, kw in modes:
            a = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **kw)
            b = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw)
            below = b[0] < 30000
            check(bool(below.sum() >= B // 4) and all(torch.equal(x[below], y[below]) for x, y in zip(a, b)),
                  f"int16 kernel != float32 kernel below the cap at B={B} L={L} {mode} "
                  f"({int(below.sum())} pairs below)")
            n_f32 += int(below.sum())
    code = lambda v: torch.full((1, 512), v, dtype=torch.int32, device=dev)  # noqa: E731
    ln = torch.tensor([512], dtype=torch.int32, device=dev)
    for ungapped, want in I16_CAP_PAIR.items():
        pair = (code(17), code(10), code(17), code(10), ln, ln, saa, s3d)
        k = sw_cuda.sw_forward_cuda(*pair, ge=1.0, ungapped=ungapped, dp_dtype="i16")
        p = sw_forward_plain(*pair, ge=1.0, ungapped=ungapped, dp_dtype="i16")
        got = (float(k[0][0]), int(k[1][0]), int(k[2][0]))
        check(got == want and all(torch.equal(a, b) for a, b in zip(k, p)),
              f"int16 512 self pair ungapped={ungapped}: kernel {got}, plain "
              f"{(float(p[0][0]), int(p[1][0]), int(p[2][0]))}, JAX {want}")
    n_seam = 0
    for B, Lq, Lt, go, ge in I16_SEAM:
        args, qc = i16_seam_inputs(ctx, B, Lq, Lt)
        for kw in [dict(gap_window=gw) for gw in I16_SEAM_WINDOWS] + [dict(ungapped=True)]:
            k = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **kw)
            p = sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **kw)
            torch.cuda.synchronize()
            kind = "ungapped_i16" if kw.get("ungapped") else "gapped_i16"
            err = float((k[0] - p[0]).abs().max())
            max_err[kind] = max(max_err[kind], err)
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"int16 kernel != plain at B={B} Lq={Lq} Lt={Lt} {kw}: "
                  f"max |best| err {err}, qend diff {int((k[1] != p[1]).sum())}, "
                  f"tend diff {int((k[2] != p[2]).sum())}")
            n_seam += 1
    log(f"[phase 2d] {n_cmp} int16 kernel-vs-plain comparisons bit-exact on (best, qend, tend), "
        f"the 512 self pair capped and wrapped as in JAX, {n_f32} pairs below the cap equal to "
        f"the float32 kernel, {n_seam} comparisons across the fold (I16_SEAM) bit-exact, "
        f"in {time.perf_counter() - t0:.1f} s")
    return max_err


def phase_i16_times(ctx, reps=20):
    """Phase 3g: the int16 instance beside the float32 one at I16_SHAPES
    (gap_window 64 and ungapped, bias on): kernel ms, the plain int16
    DP's ms (one call) and the bound (i16_bound);
    returns {(B, L, kind): numbers}."""
    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain

    saa, s3d = ctx["saa"], ctx["s3d"]
    log(f"[phase 3g] B L mode | int16 ms, float32 ms | int16 plain ms | int16 bound ms (instructions: "
        f"packed at {I16_PACKED_RATE} and the score at {ISSUE_LIMIT} a cycle an SM, at "
        f"{ctx['peak_ops'] / LANES_PER_SM / 1e9:.0f} G SM-cycles/s; bytes) | share")
    timing = {}
    for B, L, go, ge in I16_SHAPES:
        args, qc = sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
        for kind, kw in TIMED_MODES.items():
            run = lambda **d: sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw, **d)  # noqa: E731
            ms = time_cuda(lambda: run(dp_dtype="i16"), reps)
            f32_ms = time_cuda(run, reps)
            plain_ms = once_ms(lambda: sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc,
                                                        dp_dtype="i16", **kw))
            bound_ms, ops_ms, bytes_ms = i16_bound(ctx, args, qc, kind)
            timing[(B, L, kind)] = dict(ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by="operations" if ops_ms >= bytes_ms else "bytes")
            log(f"  {B:4d} {L:5d} {kind:8s} | {ms:8.4f} {f32_ms:8.4f} | {plain_ms:9.2f} | "
                f"{bound_ms:.4f} ({ops_ms:.4f}, {bytes_ms:.5f}) | {100 * bound_ms / ms:.1f} %")
    return timing


def start_probe(work, cores):
    """Start scripts/torch_probe_i16.py (its builds and launches) in a
    process of its own on `cores`; finish_probe reads it."""
    out = os.path.join(work, "probe_i16.json")
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "scripts", "torch_probe_i16.py"),
                             "--json", out], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.sched_setaffinity(0, cores))
    return proc, out, watch_exit(proc)


def watch_exit(proc):
    """(start, a thread that waits for `proc`, [its exit]) on the script's
    clock, for a span of a process that runs beside the main lane."""
    ended = []
    watch = threading.Thread(target=lambda: (proc.wait(), ended.append(clock())), daemon=True)
    watch.start()
    return clock(), watch, ended


def record_exit(name, watched, lane):
    """The span of a process watched by watch_exit, once it has exited."""
    t0, watch, ended = watched
    watch.join()
    record_span(name, t0, ended[0], lane=lane)


def finish_probe(started):
    """The probe's JSON-line row numbers; fails unless every probe built,
    ran and matched numpy."""
    proc, out, watched = started
    text, _ = proc.communicate(timeout=600)
    record_exit("int16 probe's process", watched, "probe")
    for line in text.strip().splitlines():
        log(f"[probe] {line}")
    check(proc.returncode == 0 and os.path.exists(out),
          f"scripts/torch_probe_i16.py exited {proc.returncode}: not every int16 probe passed")
    res = json.load(open(out))
    rows = res["probes"]
    check(res["passed"] == res["total"] == len(rows) and all(r["status"] == "OK" for r in rows),
          f"int16 probes: {res['passed']}/{res['total']} passed")
    return dict(ms=sum(r["ms"] for r in rows), plain_ms=sum(r["numpy_ms"] for r in rows),
                bound_ms=sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3,
                max_abs_err=float(max(r["max_abs_err"] for r in rows)), n=len(rows))


def device_busy_ms(fn, by_name=False):
    """(device ms, wall ms) of one call of `fn` under torch.profiler: the
    durations of the trace's device events (kernels, copies, fills)
    summed from the raw trace, which skips the profiler's slow
    aggregation (tens of seconds for 10^5 launches); device ms is None
    when the trace holds no device time.  With `by_name`, a third item:
    {event name: (count, ns)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            n, ns = names.get(e.name(), (0, 0))
            names[e.name()] = (n + 1, ns + e.duration_ns())
    ns = sum(ns for _, ns in names.values())
    busy = (ns / 1e6 if ns > 0 else None), wall_ms
    return (*busy, names) if by_name else busy


def phase_nw(ctx):
    """Phase 3b, checks: the NW forward on the card vs the CPU,
    bit-identical; the fused merge's count products at a full (64, 512)
    batch and the guide tree's gram over 2,048 k-mer bags, each equal to
    its CPU result.  Returns the card's inputs of phase_nw_times."""
    import torch

    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.nw_device import _count_scores, nw_forward_bits
    from unicore_tpu_torch.synthetic import nw_scores

    t0 = time.perf_counter()
    n_cmp = 0
    for c, (Lb, B) in enumerate(NW_CHECKS):
        # tie-heavy scores with the second gap pair, but not at the
        # largest size, whose CPU side takes seconds
        cases = list(zip(NW_GAPS, ("rand", ("zero", "const")[c % 2])))
        for (go, ge), kind in cases[:1] if (Lb, B) == NW_CHECKS[-1] else cases:
            S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb - 5 * (c % 3), kind)
            t = [torch.from_numpy(x) for x in (S, l1, l2)]
            cpu = nw_forward_bits(*t, go, ge)
            gpu = nw_forward_bits(*(x.to(ctx["dev"]) for x in t), go, ge)
            for name, x, y in zip(("bits", "end_i", "end_j", "score"), cpu, gpu):
                check(y.is_cuda and torch.equal(x, y.cpu()),
                      f"NW forward on CUDA != CPU in {name} at bucket {Lb}, batch {B}, {kind}, go/ge {go}/{ge}")
            n_cmp += 1

    B, Lb = NW_TIMED[0][1], NW_TIMED[0][0]
    mats = []
    for m in (ctx["saa_np"], ctx["s3d_np"]):
        p = np.zeros((32, 32))
        p[:21, :21] = m[:21, :21]
        mats.append(torch.from_numpy(p))
    counts = [torch.from_numpy(ctx["rng"].randint(0, 6, (B, Lb, 32)).astype(np.int16)) for _ in range(4)]
    n = torch.full((B,), 5, dtype=torch.int32)
    lens = torch.from_numpy(ctx["rng"].randint(1, Lb + 1, B).astype(np.int32))
    args = [*counts, n, n, lens, lens.flip(0), *mats, 14, 21]
    dargs = [x.to(ctx["dev"]) if torch.is_tensor(x) else x for x in args]
    check(torch.equal(_count_scores(*args), _count_scores(*dargs).cpu()), "count scores on CUDA != CPU")
    feats = (ctx["rng"].rand(2048, 8192) < 0.05).astype(np.int8)
    check(np.array_equal(_shared_counts(feats, "cpu"), _shared_counts(feats, ctx["dev"])),
          "guide gram on CUDA != CPU")
    log(f"[phase 3b] {n_cmp} NW forward CUDA-vs-CPU comparisons bit-identical on "
        f"(bits, end_i, end_j, score), count products and guide gram equal, in {time.perf_counter() - t0:.1f} s")
    return dict(count_args=dargs, feats=feats)


def dirbits_times(ctx, kind, d, plain, kernel, gaps, reps=20, cpu=True, profile=True):
    """Times of one direction-bit dispatch on the card's inputs `d`:
    the kernel (CUDA events over `reps` launches after a warm-up), the
    plain version (one call; the checks ran its ops), with `profile` the
    plain version's device-busy time inside one profiled dispatch, with
    `cpu` the CPU's plain time, and the kernel's bound."""
    k_ms = time_cuda(lambda: kernel(*d, *gaps), reps)
    ms = once_ms(lambda: plain(*d, *gaps))
    busy_ms, wall_ms = device_busy_ms(lambda: plain(*d, *gaps)) if profile else (None, None)
    cpu_ms = None
    if cpu:
        t = [x.cpu() for x in d]
        c0 = time.perf_counter()
        plain(*t, *gaps)
        cpu_ms = (time.perf_counter() - c0) * 1e3
    bound_ms, ops_ms, bytes_ms = dirbits_bound(ctx, d[0], kind)
    return dict(kernel_ms=k_ms, ms=ms, cpu_ms=cpu_ms, busy_ms=busy_ms, profiled_wall_ms=wall_ms,
                bound_ms=bound_ms, ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def dirbits_full_batch(kind, Lb):
    """The callers' full batch at bucket Lb: the merge pipeline's 64 pairs
    or 64 MB of int32 scores (NW), sw_traceback_batch's 64 windows or 64
    MB of int16 (SW)."""
    return max(1, min(64, (64 << 20) // (Lb * Lb * (4 if kind == "nw" else 2))))


def dirbits_batch(ctx, kind, B, Lb):
    """(S, l1, l2) on the card: a batch as the callers make it (NW int32
    merge scores, SW int16 hit windows), random kinds."""
    import torch

    from unicore_tpu_torch.synthetic import nw_scores, sw_windows

    if kind == "nw":
        S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb, "rand")
        S = S.astype(np.int32)
    else:
        S, l1, l2 = sw_windows(ctx["rng"], B, Lb, "rand")
    return [torch.from_numpy(x).to(ctx["dev"]) for x in (S, l1, l2)]


def phase_dirbits_sweep(ctx, reps=5):
    """Phase 3f: every C (columns a lane) whose row is one tile, for each
    row-width class of DIRBITS_CLASSES and both instances at the callers'
    full batch (dirbits_full_batch), bit-equal to the table's launch and
    timed (CUDA events over `reps` launches).  Prints ms and us per row,
    the fastest C and the table's; returns {(kind, class): {C: ms}}."""
    import torch

    from unicore_tpu_torch.ops import dirbits_cuda

    gaps = {"nw": NW_GAPS[0], "sw_bits": SWB_GAPS[0]}
    log(f"[phase 3f] sweep of the direction-bit kernel's columns a lane: instance class L2 (B x L1 x L2) | C warps "
        f"ms (us per row) | fastest, the table's C ({ctx['smi']})")
    out = {}
    for kind in ("nw", "sw_bits"):
        local = kind == "sw_bits"
        wrapper = dirbits_cuda.nw_forward_bits_cuda if kind == "nw" else dirbits_cuda.sw_forward_bits_cuda
        for Lb in DIRBITS_CLASSES:
            B = dirbits_full_batch(kind, Lb)
            d = dirbits_batch(ctx, kind, B, Lb)
            ref = wrapper(*d, *gaps[kind])
            table_c = dirbits_cuda.columns_of(Lb)

            def call(C):
                return dirbits_cuda.forward_bits_columns(C, *d, *gaps[kind], local)
            row = {}
            for C in dirbits_cuda.COLUMNS:
                if Lb > dirbits_cuda.band_threads(C) * C or Lb < 8 * C:
                    continue  # a row of several bands, or fewer than 8 lanes
                check(all(torch.equal(a, b) for a, b in zip(ref, call(C))),
                      f"3f: {kind} C {C} != the table's at {(B, Lb, Lb)}")
                row[C] = time_cuda(lambda: call(C), reps)
            fastest = min(row, key=row.get)
            log(f"  {kind:7s} {Lb:5d} ({B} x {Lb} x {Lb}) | "
                + ", ".join(f"C {c} warps {-(-Lb // (32 * c))} {ms:.4f} ({1e3 * ms / Lb:.4f})" for c, ms in row.items())
                + f" | fastest C {fastest}, the table's C {table_c}")
            out[(kind, Lb)] = row
    return out


def dirbits_shapes(counters):
    """{"nw", "sw_bits"}: {(B, L1, L2): launches} summed over CLI runs'
    counters {stage: counters} (ops/dirbits_cuda.shape_counters)."""
    out = {"nw": {}, "sw_bits": {}}
    for c in counters.values():
        for key, n in c.items():
            if key.startswith("kernel.dirbits.") and ".shape." in key:
                kind, shape = key[len("kernel.dirbits."):].split(".shape.")
                shape = tuple(int(v) for v in shape.split("x"))
                out[kind][shape] = out[kind].get(shape, 0) + int(n)
    return out


def merge_shapes(*hists):
    """The launch-shape histograms of several runs, summed."""
    out = {"nw": {}, "sw_bits": {}}
    for h in hists:
        for kind, shapes in h.items():
            for shape, n in shapes.items():
                out[kind][shape] = out[kind].get(shape, 0) + n
    return out


def log_dirbits_shapes(what, shapes):
    for kind, hist in shapes.items():
        if hist:
            log(f"  {what}: direction-bit kernel launch shapes, {kind} (B x L1 x L2: launches): "
                + ", ".join(f"{B}x{L1}x{L2}: {n}" for (B, L1, L2), n in sorted(hist.items(), key=lambda kv: kv[0][::-1])))


def phase_dirbits_shape_times(ctx, shapes, reps=5):
    """After phase 7a: the main path's launch shapes `shapes` ({kind: {(B,
    L1, L2): launches}}, phase 4's and 7a's histograms).  Per instance and
    bucket, one batch of the bucket's largest B on the callers' kind of
    scores and gaps, held bit-identical to the plain version on (bits,
    end_i, end_j, score) at the table's C, and timed (CUDA
    events over `reps` launches); that time stands for each of the
    bucket's launches, the kernel's time being flat in B below the SM
    count (at most a little high for the smaller B).  Prints per bucket
    the launches, their B, the time, and launches x (ms - bound) with each
    launch's own bound, summed per instance; returns {kind: (launches,
    kernel ms, launches x gap ms)}.  These launches are not counted in
    LAUNCHES: the main path's count was read before."""
    import torch

    from unicore_tpu_torch.ops import dirbits_cuda, nw_device, sw_bits

    gaps = {"nw": NW_GAPS[0], "sw_bits": SWB_GAPS[0]}
    plain = {"nw": nw_device.nw_forward_bits, "sw_bits": sw_bits.sw_forward_bits}
    log(f"[phase 3f, main-path shapes] instance bucket | launches (B) | kernel ms at the largest B, bit-identical "
        f"to plain | launches x (ms - bound) ({ctx['smi']})")
    out = {}
    for kind, hist in shapes.items():
        buckets = {}  # bucket: {B: launches}
        for (B, L1, L2), n in hist.items():
            check(L1 == L2, f"3f: a {kind} launch of {B} x {L1} x {L2} is not square")
            buckets.setdefault(L1, {})[B] = n
        n_all, ms_all, gap_all = 0, 0.0, 0.0
        for Lb, by_b in sorted(buckets.items()):
            d = dirbits_batch(ctx, kind, max(by_b), Lb)
            got = dirbits_cuda.forward_bits_columns(dirbits_cuda.columns_of(Lb), *d, *gaps[kind], kind == "sw_bits")
            for name, a, b in zip(("bits", "end_i", "end_j", "score"), got, plain[kind](*d, *gaps[kind])):
                check(torch.equal(a, b), f"3f: {kind} kernel != plain in {name} at the main-path batch "
                                         f"{max(by_b)} x {Lb} x {Lb}: {int((a != b).sum())} differ")
            ms = time_cuda(lambda: dirbits_cuda.forward_bits_columns(
                dirbits_cuda.columns_of(Lb), *d, *gaps[kind], kind == "sw_bits"), reps)
            n = sum(by_b.values())
            gap = sum(k * (ms - dirbits_bound(ctx, d[0][:B], kind)[0]) for B, k in by_b.items())
            n_all, ms_all, gap_all = n_all + n, ms_all + n * ms, gap_all + gap
            log(f"  {kind:7s} {Lb:5d} | {n:3d} (B {min(by_b)}-{max(by_b)}) | {ms:9.4f} | {gap:.3f}")
        if n_all:
            log(f"  {kind:7s} all: {n_all} launches, {ms_all:.3f} ms of kernel time, launches x (ms - bound) "
                f"{gap_all:.3f} ms")
        out[kind] = (n_all, ms_all, gap_all)
    return out


def log_dirbits_times(what, timing):
    log(f"[{what}] bucket batch S | kernel ms (us per row) | plain ms per dispatch | CPU ms | plain's device busy "
        f"ms in one profiled dispatch (its wall ms) | bound ms (ops, bytes) | kernel's share of bound")
    for (Lb, B, dtype), x in timing.items():
        busy = "not measured" if x["busy_ms"] is None else f"{x['busy_ms']:.2f}"
        cpu = "not timed" if x["cpu_ms"] is None else f"{x['cpu_ms']:9.2f}"
        wall = "" if x["profiled_wall_ms"] is None else f" ({x['profiled_wall_ms']:.2f})"
        log(f"  {Lb:6d} {B:5d} {dtype:5s} | {x['kernel_ms']:9.4f} ({1e3 * x['kernel_ms'] / Lb:.4f}) | "
            f"{x['ms']:10.2f} | {cpu} | "
            f"{busy}{wall} | {x['bound_ms']:.4f} ({x['ops_ms']:.4f}, "
            f"{x['bytes_ms']:.4f}) | {100 * x['bound_ms'] / x['kernel_ms']:.2f} %")


def phase_nw_times(ctx, inputs):
    """Phase 3b, times: the NW forward per dispatch at the merge pipeline's
    full batches, on int32 scores as the pipeline makes them and on int16
    as nw_align_batch packs them: the kernel, the plain version on the
    card and on the CPU, the plain version's device-busy time inside one
    dispatch and the bound; the count products and the guide gram.
    Returns {(bucket, batch, dtype): numbers, "counts": ms, "gram": ms}."""
    import torch

    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.dirbits_cuda import nw_forward_bits_cuda
    from unicore_tpu_torch.ops.nw_device import _count_scores, nw_forward_bits
    from unicore_tpu_torch.synthetic import nw_scores

    timing = {}
    for Lb, B in NW_TIMED:
        S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb, "rand")
        for dtype in ("int32", "int16"):
            d = [torch.from_numpy(x).to(ctx["dev"]) for x in (S.astype(dtype), l1, l2)]
            row = dtype == "int32" and (Lb, B) == NW_TIMED[0]  # the JSON line's
            timing[(Lb, B, dtype)] = dirbits_times(ctx, "nw", d, nw_forward_bits, nw_forward_bits_cuda, NW_GAPS[0],
                                                   cpu=row, profile=row)
    log_dirbits_times("phase 3b", timing)
    B, Lb = NW_TIMED[0][1], NW_TIMED[0][0]
    timing["counts"] = time_cuda(lambda: _count_scores(*inputs["count_args"]), 5)
    timing["gram"] = time_cuda(lambda: _shared_counts(inputs["feats"], ctx["dev"]), 3)
    log(f"  count products + quantization at {B} x {Lb} x {Lb}: {timing['counts']:.3f} ms; "
        f"guide gram of 2048 x 8192 bags (copies included): {timing['gram']:.3f} ms")
    return timing


def _rel_err(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def _site_err(ref, got):
    """Largest |d| / (SITE_ATOL + SITE_RTOL |s|): at most 1 to pass."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    check(ref.shape == got.shape, f"site log-likelihood shapes {ref.shape} != {got.shape}")
    return float(np.max(np.abs(got - ref) / (SITE_ATOL + SITE_RTOL * np.abs(ref))))


def _phylo_pair(msa, model, alpha, p_inv, dev):
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import models as tm

    names = list(msa)
    seqs = [msa[k] for k in names]
    freqs = tl.empirical_frequencies(tl.msa_to_codes(names, seqs))
    m = tm.SubstModel.build(tm.ModelSpec.parse(model), empirical_freqs=freqs, alpha=alpha, p_inv=p_inv)
    return tl.LikelihoodEngine(names, seqs, m, device="cpu"), tl.LikelihoodEngine(names, seqs, m, device=dev)


def _nj_start(msa, floor):
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo.nj import neighbor_joining, protein_distances

    names = list(msa)
    root = tl.make_root_binary(neighbor_joining(protein_distances(names, [msa[k] for k in names]), names))
    c, b = tl.tree_to_arrays(root, names)
    return c, np.maximum(b, floor)


def float64_loglik(eng, cb, bb):
    """lnL of each candidate through the engine's own batched functions in
    float64 on the CPU: the arbiter where its float32 sides disagree."""
    import torch

    from unicore_tpu_torch.phylo import likelihood as tl

    mp = {k: v.cpu().double() for k, v in eng._mp.items()}
    with torch.no_grad():
        sites = tl._site_loglik_batch_core(torch.as_tensor(cb), torch.as_tensor(bb, dtype=torch.float64),
                                           eng.tips.cpu().double(), **mp)
    return (sites * eng.w.cpu().double()).sum(-1).tolist()


class OpenMPTeam:
    """Code run in every thread of the calling thread's OpenMP team, the
    team torch's intra-op work (at::parallel_for) runs on: a parallel
    region of torch's own libgomp, entered through ctypes."""

    def __init__(self):
        import ctypes

        import torch

        torch.ones(2).sum()  # torch's libraries loaded
        maps = [line.split()[-1] for line in open("/proc/self/maps") if "libgomp" in line]
        self.lib = maps[0] if maps else "libgomp.so.1"
        self.gomp = ctypes.CDLL(self.lib)
        self.libm = ctypes.CDLL("libm.so.6")
        self.libc = ctypes.CDLL("libc.so.6")
        self.callback = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
        self.env_words = ctypes.c_uint32 * 8

    def each(self, fn):
        """{thread number: fn()} over the team."""
        out, lock = {}, threading.Lock()

        def body(_):
            r = fn()
            with lock:
                out[self.gomp.omp_get_thread_num()] = r

        self.gomp.GOMP_parallel(self.callback(body), None, 0, 0)
        return dict(sorted(out.items()))

    def workers(self):
        """{thread: (tid, core, MXCSR rounding, FTZ, DAZ)} of the team."""
        def one():
            env = self.env_words()
            self.libm.fegetenv(env)
            m = env[7]  # glibc's x86-64 fenv_t: the 28-byte x87 environment, then __mxcsr
            return (threading.get_native_id(), self.libc.sched_getcpu(),
                    ("nearest", "down", "up", "zero")[(m >> 13) & 3], bool(m & 0x8000), bool(m & 0x40))
        return self.each(one)

    def pin(self, cores):
        """Pin the calling thread and every thread of its team to `cores`."""
        os.sched_setaffinity(0, cores)
        self.each(lambda: os.sched_setaffinity(0, cores))


def cpu_state(team=None):
    """One line: what torch's CPU products depend on in this process."""
    import torch

    line = (f"matmul precision {torch.get_float32_matmul_precision()}, oneDNN matmul "
            f"{torch.backends.mkldnn.matmul.fp32_precision}, torch threads {torch.get_num_threads()} "
            f"(inter-op {torch.get_num_interop_threads()}), cores {sorted(os.sched_getaffinity(0))}")
    if team is not None:
        w = team.workers()
        line += "; OpenMP team (thread: core rounding FTZ DAZ) " + ", ".join(
            f"{k}: {core} {rnd} {int(ftz)} {int(daz)}" for k, (_, core, rnd, ftz, daz) in w.items())
    return line


@contextlib.contextmanager
def tf32_requested():
    """`torch.set_float32_matmul_precision("high")` inside the block, so the
    likelihood engine's full-float32 guard is what keeps TF32 out."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def phase_phylo(ctx):
    """Phase 3c, checks: the likelihood engine on the card against the CPU
    under TF32 matmul settings.  Returns the inputs of phase_phylo_times."""
    import torch

    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.synthetic import simulate_msa

    real_chunk_for = tl.pattern_chunk_for
    with tf32_requested(), contextlib.ExitStack() as undo:
        undo.callback(setattr, tl, "pattern_chunk_for", real_chunk_for)
        t0 = time.perf_counter()
        rng = np.random.RandomState(PHYLO["seed"])
        msa = simulate_msa(rng, PHYLO["n"], PHYLO["L"])
        cpu, gpu = _phylo_pair(msa, PHYLO["model"], PHYLO["alpha"], PHYLO["p_inv"], ctx["dev"])
        n, P, C = gpu.n, int(gpu.tips.shape[1]), int(gpu._mp["rates"].shape[0])
        check(gpu.tips.device.type == torch.device(ctx["dev"]).type,
              f"the likelihood engine's tensors are on {gpu.tips.device}")
        c, b = _nj_start(msa, 1e-3)
        names = gpu.names
        root = tl.arrays_to_tree(c, b, names)
        trees = ts.nni_neighbors(root)
        while len(trees) < PHYLO["batch"]:  # fill the batch with random NNI walks
            trees.append(ts.random_nni_walk(root, rng, 3))
        arr = [tl.tree_to_arrays(x, names) for x in trees[:PHYLO["batch"]]]
        cb, bb = np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])
        # the CPU side takes seconds per call at this size (8-22 s for the
        # 64 candidates, 0.25 s per Adam step), so the checks run on fewer
        # candidates and steps than the timed calls
        err = {}
        k = PHYLO["cpu_batch"]
        log(f"[phase 3c] the CPU side's state at entry: {cpu_state(OpenMPTeam())}")
        ll_batch = (cpu.loglik_batch(cb[:k], bb[:k]), gpu.loglik_batch(cb[:k], bb[:k]))
        err["loglik_batch"] = _rel_err(*ll_batch)
        err["site_loglik_batch"] = _site_err(cpu.site_loglik_batch(cb[:k], bb[:k]),
                                             gpu.site_loglik_batch(cb[:k], bb[:k]))
        moves = ts.nni_moves_arrays(c, n)
        err["loglik_nni_moves"] = _rel_err(cpu.loglik_nni_moves(c, b, moves), gpu.loglik_nni_moves(c, b, moves))
        nb_c, ll_c = cpu.optimize_blens(c, b, steps=PHYLO["steps"])
        nb_g, ll_g = gpu.optimize_blens(c, b, steps=PHYLO["steps"])
        err["optimize_blens"] = _rel_err(ll_c, ll_g)
        blen_err = float(np.max(np.abs(nb_g - nb_c) / (BLEN_ATOL + BLEN_RTOL * nb_c)))
        tl.pattern_chunk_for = lambda n_taxa, n_cat, P, budget_bytes=8e8: 2048
        err["chunked loglik_batch"] = _rel_err(cpu.loglik_batch(cb[:8], bb[:8]),
                                               gpu.loglik_batch(cb[:8], bb[:8]))
        err["chunked site_loglik_batch"] = _site_err(cpu.site_loglik_batch(cb[:4], bb[:4]),
                                                     gpu.site_loglik_batch(cb[:4], bb[:4]))
        err["chunked optimize_blens"] = _rel_err(cpu.optimize_blens(c, b, steps=5)[1],
                                                 gpu.optimize_blens(c, b, steps=5)[1])
        tl.pattern_chunk_for = real_chunk_for
        msa64 = simulate_msa(np.random.RandomState(PHYLO_INC["seed"]), PHYLO_INC["n"], PHYLO_INC["L"])
        cpu64, gpu64 = _phylo_pair(msa64, PHYLO["model"], PHYLO["alpha"], PHYLO["p_inv"], ctx["dev"])
        c64, b64 = _nj_start(msa64, 0.02)
        moves64 = ts.nni_moves_arrays(c64, PHYLO_INC["n"])
        err[f"loglik_nni_moves at {PHYLO_INC['n']} taxa"] = _rel_err(cpu64.loglik_nni_moves(c64, b64, moves64),
                                                       gpu64.loglik_nni_moves(c64, b64, moves64))
        check(torch.get_float32_matmul_precision() == "high", "the engine did not restore the matmul precision")
        if err["loglik_batch"] > LL_RTOL:  # each candidate's lnL, for the record (ROADMAP Queue 3)
            f64 = float64_loglik(cpu, cb[:k], bb[:k])
            # the CPU side again, at its thread count and at one thread: a
            # value that does not come back is the CPU side's, not the card's
            again = cpu.loglik_batch(cb[:k], bb[:k])
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                one = cpu.loglik_batch(cb[:k], bb[:k])
            finally:
                torch.set_num_threads(threads)
            alone = [float(cpu.loglik_batch(cb[i:i + 1], bb[i:i + 1])[0]) for i in range(k)]
            # five more batches: which candidates stray each time, if any
            stray = [[i for i, (x, y) in enumerate(zip(cpu.loglik_batch(cb[:k], bb[:k]), f64))
                      if abs(x - y) > 1e-6 * abs(y)] for _ in range(5)]
            log(f"  loglik_batch: {cpu_state(OpenMPTeam())}; candidates past 1e-6 of float64 in five more "
                f"batches: {stray}")
            for i, (a, g) in enumerate(zip(*ll_batch)):
                log(f"  loglik_batch candidate {i}: CPU {float(a)!r} (again {float(again[i])!r}, one thread "
                    f"{float(one[i])!r}, alone {alone[i]!r}), CUDA {float(g)!r}, float64 on the CPU {f64[i]!r}, "
                    f"relative error {abs(float(g) - float(a)) / abs(float(a)):.3g}")
        for name, e in err.items():
            lim = 1.0 if "site" in name else (BLEN_LL_RTOL if "optimize" in name else LL_RTOL)
            check(e <= lim, f"likelihood on CUDA != CPU: {name} error {e:.3g} > {lim}")
        check(blen_err <= 1.0, f"optimized branch lengths on CUDA != CPU: {blen_err:.3g} of the tolerance")
        log(f"[phase 3c] likelihood CUDA vs CPU under TF32 settings at {n} taxa x {P} patterns, "
            f"{C} categories, {len(cb)} candidates ({len(moves)} NNI moves; {len(moves64)} at "
            f"{PHYLO_INC['n']} taxa) in {time.perf_counter() - t0:.1f} s; errors (lnL relative; "
            f"sites and lengths as a share of their tolerance): "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items()) + f", branch lengths {blen_err:.3g}")
        return dict(cpu=cpu, gpu=gpu, c=c, b=b, cb=cb, bb=bb, moves=moves)


def phase_phylo_times(ctx, st):
    """Phase 3c, times (under TF32 settings, as the checks): ms per
    `loglik_batch` on the card and on the CPU, per Adam step, the
    device-busy share of Adam steps and the bound of one `loglik_batch`.
    Returns the numbers."""
    cpu, gpu, c, b, cb, bb, moves = (st[k] for k in ("cpu", "gpu", "c", "b", "cb", "bb", "moves"))
    n, P, C = gpu.n, int(gpu.tips.shape[1]), int(gpu._mp["rates"].shape[0])
    with tf32_requested():
        lb_ms = time_cuda(lambda: gpu.loglik_batch(cb, bb), 5)
        c0 = time.perf_counter()
        cpu.loglik_batch(cb[:PHYLO["cpu_batch"]], bb[:PHYLO["cpu_batch"]])
        lb_cpu_ms = (time.perf_counter() - c0) * 1e3
        sb_ms = time_cuda(lambda: gpu.site_loglik_batch(cb, bb), 3)
        nm_ms = time_cuda(lambda: gpu.loglik_nni_moves(c, b, moves), 3)
        walls = {}
        gpu.optimize_blens(c, b, steps=10)  # warm-up
        for steps in (10, ADAM_TIMED_STEPS):
            w0 = time.perf_counter()
            gpu.optimize_blens(c, b, steps=steps)
            walls[steps] = (time.perf_counter() - w0) * 1e3
        step_ms = (walls[ADAM_TIMED_STEPS] - walls[10]) / (ADAM_TIMED_STEPS - 10)
        busy_ms, prof_ms = device_busy_ms(lambda: gpu.optimize_blens(c, b, steps=10))
        # the bound of one loglik_batch call: per candidate and internal node
        # two products (P, C*20) x per-category (20, 20) blocks, at least
        # C * 20 * 20 multiply-adds per pattern each; bytes: tips, weights,
        # topologies and lengths read once, one lnL per candidate written
        B = len(cb)
        flops = B * (n - 1) * 2 * 2.0 * P * C * 20 * 20
        nbytes = n * P * 20 * 4 + P * 4 + cb.size * 8 + bb.size * 4 + B * 4
        bound_ms = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        busy = "not measured" if busy_ms is None else f"{busy_ms / 10:.3f} ms of it busy ({100 * busy_ms / prof_ms:.1f} %)"
        log(f"[phase 3c] loglik_batch ({B} candidates): {lb_ms:.2f} ms on the card; {PHYLO['cpu_batch']} candidates "
            f"{lb_cpu_ms:.1f} ms on the CPU; "
            f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at FP32 peak, executed block-diagonally: "
            f"x{C}; {nbytes / 1e6:.2f} MB); site_loglik_batch {sb_ms:.2f} ms; loglik_nni_moves "
            f"({len(moves)} moves) {nm_ms:.2f} ms")
        log(f"  optimize_blens: {walls[ADAM_TIMED_STEPS]:.1f} ms for {ADAM_TIMED_STEPS} Adam steps, "
            f"{step_ms:.3f} ms per step (their time less a 10-step call's); "
            f"profiled 10-step call {prof_ms:.1f} ms, per step {busy}")
    return dict(loglik_batch_ms=lb_ms, loglik_batch_cpu_ms=lb_cpu_ms, bound_ms=bound_ms,
                adam_step_ms=step_ms, busy_ms=busy_ms, profiled_ms=prof_ms)


def phase_sw_bits(ctx):
    """Phase 3d, checks: the traceback DP (ops/sw_bits.py, PyTorch ops) on
    the card against the same function on the CPU, bit-identical on
    (bits, best_i, best_j, score).  Returns the card's inputs of
    phase_sw_bits_times."""
    import torch

    from unicore_tpu_torch.ops.sw_bits import sw_forward_bits
    from unicore_tpu_torch.synthetic import SW_WINDOW_KINDS, sw_windows

    t0 = time.perf_counter()
    n_cmp = 0
    for c, (Lb, B) in enumerate(SWB_CHECKS):
        for k, kind in enumerate(SW_WINDOW_KINDS):
            # both gap pairs, but one (alternating) at the largest size,
            # whose CPU side takes seconds
            for go, ge in [SWB_GAPS[k % 2]] if (Lb, B) == SWB_CHECKS[-1] else SWB_GAPS:
                t = [torch.from_numpy(x) for x in sw_windows(ctx["rng"], B, Lb, kind)]
                cpu = sw_forward_bits(*t, go, ge)
                gpu = sw_forward_bits(*(x.to(ctx["dev"]) for x in t), go, ge)
                for name, x, y in zip(("bits", "best_i", "best_j", "score"), cpu, gpu):
                    check(y.is_cuda and torch.equal(x, y.cpu()),
                          f"sw_forward_bits on CUDA != CPU in {name} at bucket {Lb}, batch {B}, {kind}, go/ge {go}/{ge}")
                n_cmp += 1
    log(f"[phase 3d] {n_cmp} SW traceback forward (sw_forward_bits) CUDA-vs-CPU comparisons bit-identical on "
        f"(bits, best_i, best_j, score) in {time.perf_counter() - t0:.1f} s")
    return {(Lb, B): [torch.from_numpy(x).to(ctx["dev"]) for x in sw_windows(ctx["rng"], B, Lb, "rand")]
            for Lb, B in SWB_TIMED}


def phase_sw_bits_times(ctx, inputs):
    """Phase 3d, times: one dispatch of the traceback DP at the full
    batches of buckets 512 and 1,024 (int16 scores, as sw_traceback_batch
    packs them): the kernel, the plain version on the card and on the CPU,
    the plain version's device-busy time inside one dispatch and the
    bound.  Returns {(bucket, batch, dtype): numbers}."""
    from unicore_tpu_torch.ops.dirbits_cuda import sw_forward_bits_cuda
    from unicore_tpu_torch.ops.sw_bits import sw_forward_bits

    timing = {(Lb, B, "int16"): dirbits_times(ctx, "sw_bits", d, sw_forward_bits, sw_forward_bits_cuda, SWB_GAPS[0],
                                              cpu=(Lb, B) == SWB_TIMED[0], profile=(Lb, B) == SWB_TIMED[0])
              for (Lb, B), d in inputs.items()}
    log_dirbits_times("phase 3d", timing)
    return timing


def phase_slice(work, n_species=N_SPECIES, per_species=PER_SPECIES):
    """Phase 4: createdb -> cluster -> profile -> tree -n at a real size;
    returns the kernels' launches per mode in that run ("gapped",
    "ungapped", the banded kernel's "banded.gapped", "banded.ungapped"
    and the direction-bit kernel's "nw", "sw_bits") and the counters of
    its inference."""
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda

    # the main path runs in the CLI subprocesses below, whose counts start
    # at 0 and are read back from their counters files
    sw_cuda.reset_launch_counts()
    banded_cuda.reset_launch_counts()
    dirbits_cuda.reset_launch_counts()
    in_dir = os.path.join(work, "proteomes")
    labels = synthetic.write_proteomes(in_dir, n_species, per_species, seed=7)
    lengths = []
    for fn in os.listdir(in_dir):
        lengths += [len(l.strip()) for l in open(os.path.join(in_dir, fn)) if not l.startswith(">")]
    lengths = np.array(lengths)
    log(f"[phase 4] {len(lengths)} sequences ({n_species} x {per_species}), median length "
        f"{int(np.median(lengths))}, {100 * np.mean(lengths > 1024):.1f}% longer than 1024")
    out_dir = os.path.join(work, "main")
    times, counters = run_slice(in_dir, out_dir, os.path.join(work, "home_main"), one_process=True, inference=True)
    c, t = counters["cluster"], counters["tree"]
    launches = kernel_launches(c)
    nw = dirbits_launches(counters)
    purity, n_clusters = synthetic.cluster_purity(out_dir, labels)
    genes, width, n_parts = check_tree(out_dir, n_species)
    log("  the CLI calls' own seconds, one after another in one process (cli_chain)")
    for stage in ("createdb", "cluster", "profile", "tree"):
        log(f"  {stage:8s} {times[stage]:8.2f} s")
    log(f"  sequences {int(c['cluster.sequences'])}, candidate pairs {int(c['cluster.candidate_pairs'])}, "
        f"kept by rescore {int(c['rescore.kept'])}, hits {int(c['cluster.hits'])}, "
        f"clusters {int(c['cluster.clusters'])}, core genes {len(genes)}")
    log(f"  align.cells {c['align.cells']:.4g}, rescore.cells {c['rescore.cells']:.4g}, "
        f"align.seconds {c['align.seconds']:.2f}, rescore.seconds {c['rescore.seconds']:.2f}, "
        f"banded.seconds {c.get('banded.seconds', 0.0):.2f} (inside the two before: seed "
        f"{c.get('banded.seed.seconds', 0.0):.2f}, pack {c.get('banded.pack.seconds', 0.0):.2f}, device "
        f"{c.get('banded.device.seconds', 0.0):.2f}; {int(c.get('banded.launches', 0))} launches, "
        f"banded.pairs {int(c.get('banded.pairs', 0))}, banded.buckets {int(c.get('banded.buckets', 0))}), "
        f"prefilter.featurize.seconds {c.get('prefilter.featurize.seconds', 0.0):.3f}, "
        f"stage.cluster.seconds {c['stage.cluster.seconds']:.2f}")
    log(f"  tree: genes aligned {len(genes)}, msa.cells {t['msa.cells']:.4g}, "
        f"msa.seconds {t['msa.seconds']:.2f}, msa.nw.seconds {t['msa.nw.seconds']:.2f}, "
        f"msa.dispatches {int(t['msa.dispatches'])} (direction-bit kernel launches {nw['nw']}), host-route merges "
        f"{int(t.get('msa.host_route_merges', 0))}, stage.tree.seconds {t['stage.tree.seconds']:.2f}; "
        f"supermatrix {n_species} x {width}, {n_parts} partitions")
    log(f"  kernel launches {launches}; cluster purity {purity:.4f} over {n_clusters} clusters "
        f"(floor {PURITY_FLOOR})")
    check(all(launches[k] > 0 for k in ("gapped", "ungapped", "banded.gapped", "banded.ungapped")),
          f"the main path did not launch every kernel mode: {launches}")
    check_banded_route(c, launches, "phase 4")
    check(purity >= PURITY_FLOOR, f"cluster purity {purity:.4f} < {PURITY_FLOOR}")
    check(t["msa.dispatches"] > 0, "the tree stage ran no NW forward")
    check(nw["nw"] == int(t["msa.dispatches"]),
          f"phase 4: {int(t['msa.dispatches'])} NW forward dispatches, {nw['nw']} direction-bit kernel launches")
    shapes = dirbits_shapes(counters)
    log_dirbits_shapes("phase 4", shapes)
    check(sum(shapes["nw"].values()) == nw["nw"], f"phase 4: the launch shapes count {shapes['nw']}, not {nw['nw']}")
    launches.update(nw)
    launches["dirbits_shapes"] = shapes
    return launches, phase_inference(out_dir, n_species, times["tree_inference"], counters["tree_inference"])


def kernel_launches(counters):
    """{mode: launches} of both kernels in a CLI run's counters, the SW
    kernel's int16 instance ("gapped_i16", "ungapped_i16") among them."""
    out = {k: int(counters.get(f"kernel.sw.{k}.launches", 0))
           for k in ("gapped", "ungapped", "gapped_i16", "ungapped_i16")}
    out.update({f"banded.{k}": int(counters.get(f"kernel.banded.{k}.launches", 0)) for k in ("gapped", "ungapped")})
    return out


def dirbits_launches(counters):
    """{"nw", "sw_bits"}: the direction-bit kernel's launches summed over
    CLI runs' counters {stage: counters}."""
    return {k: sum(int(c.get(f"kernel.dirbits.{k}.launches", 0)) for c in counters.values())
            for k in ("nw", "sw_bits")}


def check_banded_route(counters, launches, what):
    """Every banded batch the engine dispatched (`banded.launches`) went
    through the banded kernel."""
    n = int(counters.get("banded.launches", 0))
    k = launches["banded.gapped"] + launches["banded.ungapped"]
    check(n == k, f"{what}: {n} banded batches, {k} banded kernel launches")


def phase_inference(out_dir, n_species, seconds, c):
    """Phase 4, second part: the checks of `tree` with its defaults on
    phase 4's output directory (the skip path: inference alone; its
    seconds and counters `c`, run_slice's last step); returns c."""
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.phylo.newick import bipartitions, parse_newick, rf_distance

    tree_dir = os.path.join(out_dir, "tree")
    tree = parse_newick(open(os.path.join(tree_dir, "iqtree.treefile")).read())
    species = sorted(x.name for x in tree.leaves())
    check(species == [f"sp{i:02d}" for i in range(n_species)], f"iqtree.treefile leaves: {species}")
    every = [nd.support for nd in bipartitions(tree).values()]
    sup = [s for s in every if s is not None]
    check(len(every) == n_species - 3 and len(sup) >= len(every) - 1 and all(0.0 <= s <= 100.0 for s in sup),
          f"internal splits without a support in [0, 100] (one may have none): {every}")
    report = report_lines(open(os.path.join(tree_dir, "iqtree.iqtree"), "rb").read())
    lnl = float(report["lnL"])
    check(np.isfinite(lnl), f"lnL {lnl}")
    check(open(os.path.join(tree_dir, "tree.chk")).read() == "1", "tree.chk does not read 1")
    rf = rf_distance(tree, synthetic.species_tree(n_species, seed=7)) / (2 * (n_species - 3))
    log(f"  tree inference (skip path, iqtree -m JTT+F+I+G -B 1000) {seconds:8.2f} s: "
        f"stage.tree.inference.seconds {c['stage.tree.inference.seconds']:.2f}, phylo.seconds "
        f"{c['phylo.seconds']:.2f}, phylo.patterns {int(c['phylo.patterns'])}, phylo.blen_steps "
        f"{int(c['phylo.blen_steps'])}, phylo.candidates {int(c['phylo.candidates'])}; lnL {lnl:.4f}, "
        f"alpha {report['alpha']}, p_inv {report['p_inv']}; {len(sup)} of {len(every)} splits labelled, "
        f"supports min {min(sup):.1f} mean {np.mean(sup):.1f}; normalized RF to the generating species tree {rf:.4f} (floor {RF_FLOOR})")
    check(rf <= RF_FLOOR, f"normalized RF {rf:.4f} to the generating species tree > {RF_FLOOR}")
    return c


def phase_search(ctx, work):
    """Phase 7a: `search` at phase 4's full width on CUDA, as a CLI
    subprocess with a fresh HOME (the E-value fit runs on the kernel): a
    reference DB of one sequence per SEARCH_REF_STRIDE-th core gene of
    phase 4 and per core gene longer than SEARCH_REF_LONG
    (write_reference_db) against phase 4's 2,400-sequence proteome DB,
    default options, then
    `profile` on its m8.  Requires every reference's self hit with fident
    1.000, mismatch 0 and gapopen 0, the m8 grouped by reference, both
    kernel modes launched, search.chk "1", and the banded traceback taken
    where a reference is longer than 1,024.  Returns the launches."""
    import itertools

    from unicore_tpu_torch.io.seqdb import SeqDB

    out_dir = os.path.join(work, "main")
    db = os.path.join(out_dir, "proteome", "proteome_db")
    seqdb = SeqDB.read(db, require_ss=True)
    idx = seqdb.name_to_idx()
    genes4 = [g for k, g in enumerate(core_genes(out_dir))
              if k % SEARCH_REF_STRIDE == 0 or len(seqdb.aa_seqs[idx[g]]) > SEARCH_REF_LONG]
    s_dir = os.path.join(work, "search7a")
    ref = os.path.join(s_dir, "ref", "ref_db")
    lengths = write_reference_db(db, genes4, ref)
    m8 = os.path.join(s_dir, "search", "search")
    times, counters = run_steps(
        [("search", ["search", db, ref, m8, os.path.join(s_dir, "tmp"), "-s", SEARCH_OPTIONS])],
        s_dir, os.path.join(work, "home_search"))
    c = counters["search"]
    from unicore_tpu_torch.cli import main as cli_main  # profile is host code: in this process
    t0 = time.perf_counter()
    check(cli_main(["profile", db, m8 + ".m8", os.path.join(s_dir, "profile"), "-v", "2"]) == 0,
          "7a: profile on search.m8 failed")
    times["search_profile"] = time.perf_counter() - t0
    rows = [line.split("\t") for line in open(m8 + ".m8").read().splitlines()]
    order = [r[0] for r in rows]
    check(len([k for k, _ in itertools.groupby(order)]) == len(set(order)), "7a: the m8 is not grouped by reference")
    selfs = {r[0]: (r[2], r[4], r[5]) for r in rows if r[0] == f"AF-{r[1]}-F1"}  # fident, mismatch, gapopen
    bad = [g for g in genes4 if selfs.get(f"AF-{g}-F1") != ("1.000", "0", "0")]
    check(not bad, f"7a: references without a self hit of fident 1.000, mismatch 0, gapopen 0: {bad[:5]}")
    launches = kernel_launches(c)
    check(launches["gapped"] > 0 and launches["ungapped"] > 0, f"7a did not launch both kernel modes: {launches}")
    launches.update(dirbits_launches(counters))
    check(launches["sw_bits"] == int(c["traceback.dispatches"]) > 0,
          f"7a: {int(c['traceback.dispatches'])} traceback forward dispatches, {launches['sw_bits']} "
          f"direction-bit kernel launches")
    check_banded_route(c, launches, "7a")
    shapes = dirbits_shapes(counters)
    log_dirbits_shapes("7a", shapes)
    check(sum(shapes["sw_bits"].values()) == launches["sw_bits"],
          f"7a: the launch shapes count {shapes['sw_bits']}, not {launches['sw_bits']}")
    launches["dirbits_shapes"] = shapes
    check(open(os.path.join(s_dir, "search", "search.chk")).read() == "1", "7a: search.chk does not read 1")
    n_long = sum(L > 1024 for L in lengths)
    check(n_long == 0 or c.get("traceback.banded", 0) > 0, "7a: no window took the banded traceback")
    genes7 = core_genes(s_dir)
    log(f"[phase 7a] search (-s \"{SEARCH_OPTIONS}\") of {len(genes4)} references ({n_long} longer than 1,024) "
        f"against phase 4's proteome DB on CUDA: "
        f"{times['search']:.2f} s of subprocess wall (stage.search.seconds {c['stage.search.seconds']:.2f}, "
        f"traceback_fill {c['traceback.fill_seconds']:.2f} s of it, traceback.seconds "
        f"{c['traceback.seconds']:.2f}, traceback forward dispatches {int(c['traceback.dispatches'])}, every one "
        f"a direction-bit kernel launch); candidate pairs {int(c['search.candidate_pairs'])}, hits "
        f"{int(c['search.hits'])}; traceback windows batched {int(c['traceback.batched'])}, banded "
        f"{int(c.get('traceback.banded', 0))}, full Gotoh {int(c.get('traceback.full', 0))}; kernel launches "
        f"{launches}; every self hit at fident 1.000 ({ctx['smi']})")
    log(f"  profile on search.m8 (in process): {times['search_profile']:.2f} s, {len(genes7)} core genes, "
        f"{len(set(genes7) & set(genes4))} of them among the {len(genes4)} references")
    return launches


def phase_partition(ctx, work, inference_counters):
    """Phase 7d: the partitioned engine at phase 4's full width (its
    supermatrix, partition file and final tree, JTT+F+I+G at the
    report's alpha and p_inv) on the card against the CPU under TF32
    settings: loglik within LL_RTOL, site_loglik within SITE_ATOL +
    SITE_RTOL |s|; then ms per call and per Adam step, the device-busy
    share of a PARTITION_ADAM_STEPS-step optimize_blens, each call's
    bound (as phase 3c's, on the padded G_pad x Pmax shapes), and an
    extrapolation of a full `tree -p -B 1000` at this size from phase 4's
    counts of Adam steps and scored topologies."""
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo.models import ModelSpec
    from unicore_tpu_torch.phylo.newick import parse_newick
    from unicore_tpu_torch.phylo.partition import PartitionedLikelihoodEngine, parse_partition_file

    tree_dir = os.path.join(work, "main", "tree")
    msa = read_fasta(os.path.join(tree_dir, "combined.fasta"))
    parts = parse_partition_file(os.path.join(tree_dir, "combined.fasta.partitions"))
    report = report_lines(open(os.path.join(tree_dir, "iqtree.iqtree"), "rb").read())
    names, seqs = list(msa), list(msa.values())
    kw = dict(spec=ModelSpec.parse("JTT+F+I+G"), alpha=float(report["alpha"]), p_inv=float(report["p_inv"]))
    t0 = time.perf_counter()
    cpu = PartitionedLikelihoodEngine(names, seqs, parts, device="cpu", **kw)
    gpu = PartitionedLikelihoodEngine(names, seqs, parts, device=ctx["dev"], **kw)
    c, b = tl.tree_to_arrays(tl.make_root_binary(parse_newick(open(os.path.join(tree_dir, "iqtree.treefile")).read())),
                             names)
    n, G, Gp, Pm, C = gpu.n, gpu.G, gpu._G_pad, gpu.Pmax, int(gpu._mp["rates"].shape[-1])
    with tf32_requested():
        c0 = time.perf_counter()
        ll_c = cpu.loglik(c, b)
        ll_cpu_ms = (time.perf_counter() - c0) * 1e3
        c0 = time.perf_counter()
        site_c = cpu.site_loglik(c, b)
        site_cpu_ms = (time.perf_counter() - c0) * 1e3
        ll_g, site_g = gpu.loglik(c, b), gpu.site_loglik(c, b)
        ll_err, site_err = _rel_err(ll_c, ll_g), _site_err(site_c, site_g)
        check(ll_err <= LL_RTOL, f"7d: partitioned loglik CUDA {ll_g} vs CPU {ll_c}")
        check(site_err <= 1.0, f"7d: partitioned site_loglik CUDA vs CPU at {site_err:.3g} of the tolerance")
        ll_ms = time_cuda(lambda: gpu.loglik(c, b), 3)
        site_ms = time_cuda(lambda: gpu.site_loglik(c, b), 3)
        steps = PARTITION_ADAM_STEPS
        gpu.optimize_blens(c, b, steps=2)  # warm-up
        w0 = time.perf_counter()
        nb, ll_opt = gpu.optimize_blens(c, b, steps=steps)
        step_ms = (time.perf_counter() - w0) * 1e3 / (steps + 1)  # steps + the final evaluation
        busy_ms, prof_ms = device_busy_ms(lambda: gpu.optimize_blens(c, b, steps=PROFILED_STEPS))
    check(np.isfinite(ll_opt) and ll_opt >= ll_g - LL_RTOL * abs(ll_g), f"7d: Adam from {ll_g} ended at {ll_opt}")
    # the bound of one call: per partition (padded), internal node and
    # child, a (Pmax, C*20) x per-category (20, 20) product, C*20*20 MACs
    # per pattern; bytes: tips, weights, topology and lengths read once,
    # the result (a scalar, or a site per padded pattern) written once.
    # An Adam step is a forward and a backward pass: 3x the products.
    flops = Gp * (n - 1) * 2 * 2.0 * Pm * C * 20 * 20
    nbytes = Gp * n * Pm * 20 * 4 + Gp * Pm * 4 + c.size * 8 + b.size * 4
    bound = {k: max(f / FP32_FLOPS_PER_S, (nbytes + extra) / HBM_BYTES_PER_S) * 1e3
             for k, f, extra in (("loglik", flops, 4), ("site_loglik", flops, Gp * Pm * 4),
                                 ("adam_step", 3 * flops, b.size * 4))}
    busy = "not measured" if busy_ms is None else \
        f"{busy_ms / (PROFILED_STEPS + 1):.2f} ms of each busy ({100 * busy_ms / prof_ms:.1f} %)"
    log(f"[phase 7d] partitioned likelihood at phase 4's width: {n} taxa, {G} partitions (padded to {Gp}), "
        f"{len(gpu.weights)} patterns (padded to {Gp} x {Pm} = {Gp * Pm}), C = {C}; CUDA vs CPU under TF32 "
        f"settings: loglik relative error {ll_err:.3g}, site_loglik {site_err:.3g} of its tolerance "
        f"({time.perf_counter() - t0:.1f} s) ({ctx['smi']})")
    log(f"  loglik {ll_ms:.2f} ms (CPU {ll_cpu_ms:.1f} ms), bound {bound['loglik']:.4f} ms; site_loglik "
        f"{site_ms:.2f} ms (CPU {site_cpu_ms:.1f} ms), bound {bound['site_loglik']:.4f} ms; Adam "
        f"{step_ms:.2f} ms per step ({steps} steps, lnL {ll_g:.4f} -> {ll_opt:.4f}), bound "
        f"{bound['adam_step']:.4f} ms; profiled {PROFILED_STEPS}-step call {prof_ms:.1f} ms, {busy}")
    ic = inference_counters
    est_s = (ic["phylo.blen_steps"] * step_ms + ic["phylo.candidates"] * max(ll_ms, site_ms)) / 1e3
    log(f"  extrapolation, not a measurement: a `tree -p -B 1000` at this size making phase 4's "
        f"{int(ic['phylo.blen_steps'])} Adam steps and scoring its {int(ic['phylo.candidates'])} topologies "
        f"(counts of its unpartitioned run, whose search used an 8,192-pattern subsample) on every pattern "
        f"would take about {est_s:.0f} s of these calls")
    return dict(loglik_ms=ll_ms, site_ms=site_ms, step_ms=step_ms, busy_ms=busy_ms, profiled_ms=prof_ms,
                bound=bound, est_s=est_s)


def cascade_step(db_path, tsv, threshold):
    """cluster_db(..., cascade_threshold=threshold) on a seqdb (the cascade
    has no CLI option), the clusters written to `tsv`; with
    UNICORE_TPU_TORCH_COUNTERS set, the counters and kernel launches go to
    that file as the CLI writes them.  Returns (db, counters, seconds)."""
    from unicore_tpu_torch.align.clustering import write_cluster_tsv
    from unicore_tpu_torch.align.engine import AlignParams
    from unicore_tpu_torch.io.seqdb import SeqDB
    from unicore_tpu_torch.modules.cluster import cluster_db
    from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
    from unicore_tpu_torch.runtime import logging as msg
    from unicore_tpu_torch.runtime import profiling

    msg.set_verbosity(2)
    db = SeqDB.read(db_path, require_ss=True)
    profiling.reset_counters()
    sw_cuda.reset_launch_counts()
    banded_cuda.reset_launch_counts()
    dirbits_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    clusters, _ = cluster_db(db, AlignParams.from_options("-c 0.8"), cascade_threshold=threshold)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(tsv), exist_ok=True)
    write_cluster_tsv(tsv, clusters, db.names)
    counters = dict(profiling.get_counters(), **{f"kernel.sw.{k}.launches": v
                                                 for k, v in {**sw_cuda.LAUNCHES, **sw_cuda.I16_LAUNCHES}.items()},
                    **{f"kernel.banded.{k}.launches": v for k, v in banded_cuda.LAUNCHES.items()},
                    **{f"kernel.dirbits.{k}.launches": v for k, v in dirbits_cuda.LAUNCHES.items()})
    if os.environ.get("UNICORE_TPU_TORCH_COUNTERS"):
        profiling.dump(os.environ["UNICORE_TPU_TORCH_COUNTERS"], counters)
    return db, counters, seconds


def core_genes(out_dir):
    return sorted(n[:-4] for n in os.listdir(os.path.join(out_dir, "profile")) if n.endswith(".txt"))


def gene_key(msa_file):
    """(taxa, pattern bucket) of a gene MSA: its lockstep group."""
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo.genebatch import pattern_bucket
    from unicore_tpu_torch.phylo.likelihood import compress_patterns, msa_to_codes

    msa = read_fasta(msa_file)
    p = compress_patterns(msa_to_codes(list(msa), list(msa.values())))[0].shape[1]
    return len(msa), pattern_bucket(p), p


def cascade_steps(work, device):
    """Phase 6b on one device, in one process: its 5 x 16 proteomes
    (written by start_crosscheck) through createdb into a directory of
    their own, then the cascade at CROSS_CASCADE_THRESHOLD."""
    db = os.path.join(work, f"casc_{device}", "proteome", "proteome_db")
    code = (f"import chip_smoke as c; from unicore_tpu_torch.cli import main; "
            f"assert main(['createdb', {os.path.join(work, 'casc_in')!r}, {db!r}, 'mock', '-v', '2']) == 0; "
            f"c.cascade_step({db!r}, {os.path.join(work, f'casc_{device}', 'cluster', 'clust.tsv')!r}, "
            f"{CROSS_CASCADE_THRESHOLD})")
    return [(f"cascade_{device}", ["-c", code])]


def genetree_steps(work, x_dir, device):
    """Phase 6d on one device: gene-tree with its defaults on a copy of the
    first CROSS_GENETREE_GENES core genes of phase 5's output `x_dir`
    (phase 5 compares x_dir's own files)."""
    gt = os.path.join(work, f"gt_{device}")
    genes = core_genes(x_dir)[:CROSS_GENETREE_GENES]
    for g in genes:
        shutil.copytree(os.path.join(x_dir, "tree", "fasta", g), os.path.join(gt, "fasta", g))
    names = os.path.join(work, f"gt_{device}_names.txt")
    with open(names, "w") as f:
        f.write("".join(g + "\n" for g in genes))
    return [(f"genetree_{device}", ["gene-tree", gt, "--name", names])]


def write_reference_db(db_path, genes, out_path):
    """A reference DB of one sequence per core gene: the gene's cluster
    representative (whose name the gene carries), its AA and mock 3Di
    read from the proteome DB, named AF-<name>-F1 as AFDB entries are
    (profile's display name is then <name>).  Returns the lengths."""
    from unicore_tpu_torch.io.seqdb import SeqDB

    db = SeqDB.read(db_path, require_ss=True)
    idx = db.name_to_idx()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    SeqDB(names=[f"AF-{g}-F1" for g in genes], aa_seqs=[db.aa_seqs[idx[g]] for g in genes],
          ss_seqs=[db.ss_seqs[idx[g]] for g in genes]).write(out_path)
    return [len(db.aa_seqs[idx[g]]) for g in genes]


def easy_search_steps(work, x_dir, device):
    """Phase 7b on one device: easy-search with its defaults on phase 5's
    proteomes against a reference DB of the core genes of phase 5's
    output `x_dir`."""
    ref = os.path.join(work, f"ref7b_{device}", "ref_db")
    write_reference_db(os.path.join(x_dir, "proteome", "proteome_db"), core_genes(x_dir), ref)
    return [(f"easy_search_{device}", ["easy-search", os.path.join(work, "small"), ref,
                                       os.path.join(work, f"es_{device}"), "mock",
                                       os.path.join(work, f"es_tmp_{device}")])]


def partition_tree_steps(work, x_dir, device):
    """Phase 7c on one device: `tree` with its defaults and `-p` on the
    partition file, on a copy of the supermatrix of phase 5's output
    `x_dir` (the skip path: inference alone)."""
    tp = os.path.join(work, f"tp_{device}")
    os.makedirs(tp)
    for f in ("combined.fasta", "combined.fasta.partitions"):
        shutil.copy(os.path.join(x_dir, "tree", f), os.path.join(tp, f))
    opts = PARTITION_OPTIONS.format(os.path.join(tp, "combined.fasta.partitions"))
    return [(f"tree_partitioned_{device}", ["tree", os.path.join(x_dir, "proteome", "proteome_db"),
                                            os.path.join(x_dir, "profile"), tp, f"--tree-options={opts}"])]


def cross_sides(work, x_dir, device, trees):
    """The steps on phase 5's easy-core output `x_dir`, on one device, as
    side-by-side lists (run_easy_core's `sides`): on the CPU three, 7c
    (the partitioned engine on every pattern) and 6d, tree -T raxml-ng
    and tree -T fasttree, the two other aligners and 7b; on CUDA three,
    raxml-ng, 7c and 6d, and the rest."""
    p7c = partition_tree_steps(work, x_dir, device)
    p6d = genetree_steps(work, x_dir, device)
    p7b = easy_search_steps(work, x_dir, device)
    t = trees
    if device == "cpu":
        return [p7c + p6d, [t["tree_raxml"], t["tree_fasttree"]], [t["tree_mafft"], t["tree_linsi"], *p7b]]
    return [[t["tree_raxml"]], [*p7c, *p6d], [t["tree_mafft"], t["tree_linsi"], t["tree_fasttree"], *p7b]]


def check_gene_trees(root, genes, supported=True):
    """Each gene dir's iqtree outputs: a tree over the gene's taxa, at most
    one internal split without a support and the others in [0, 100], a
    finite lnL, and n_patterns the unpadded count of its MSA.  Returns
    {gene: report lines}."""
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo.newick import bipartitions, parse_newick

    reports = {}
    for g in genes:
        d = os.path.join(root, "fasta", g)
        taxa = sorted(read_fasta(os.path.join(d, f"{g}.fa.filtered")))
        tree = parse_newick(open(os.path.join(d, "iqtree.treefile")).read())
        check(sorted(x.name for x in tree.leaves()) == taxa, f"gene {g}: iqtree.treefile leaves != its taxa")
        sups = [nd.support for nd in bipartitions(tree).values()]
        labelled = [x for x in sups if x is not None]
        check(len(labelled) >= len(sups) - 1 and all(0.0 <= x <= 100.0 for x in labelled),
              f"gene {g}: supports {sups}")
        rep = report_lines(open(os.path.join(d, "iqtree.iqtree"), "rb").read())
        check(np.isfinite(float(rep["lnL"])), f"gene {g}: lnL {rep['lnL']}")
        p = gene_key(os.path.join(d, f"{g}.fa.filtered"))[2]
        check(int(rep["n_patterns"]) == p, f"gene {g}: n_patterns {rep['n_patterns']}, its MSA has {p}")
        reports[g] = rep
    return reports


def phase_cascade(ctx, work):
    """Phase 6a: the cascade in process on CUDA on 20 x CASCADE_PER_SPECIES
    proteomes (phase 4's seed and generator; threshold CASCADE_THRESHOLD):
    every sequence in one cluster, purity against the families, both
    kernel modes launched."""
    from unicore_tpu_torch import synthetic

    started = clock()

    in_dir, out = os.path.join(work, "cascade_in"), os.path.join(work, "cascade")
    labels = synthetic.write_proteomes(in_dir, N_SPECIES, CASCADE_PER_SPECIES, seed=7)
    db = os.path.join(out, "proteome", "proteome_db")
    run_steps([("cascade_createdb", ["createdb", in_dir, db, "mock"])], out, os.path.join(work, "home_cascade"))
    seqdb, c, seconds = cascade_step(db, os.path.join(out, "cluster", "clust.tsv"), CASCADE_THRESHOLD)
    members = [line.split("\t")[1] for line in open(os.path.join(out, "cluster", "clust.tsv")).read().splitlines()]
    check(sorted(members) == sorted(seqdb.names), "the cascade's clusters do not hold every sequence exactly once")
    purity, n_clusters = synthetic.cluster_purity(out, labels)
    launches = {k: int(c[f"kernel.sw.{k}.launches"]) for k in ("gapped", "ungapped")}
    banded_launches = {k: int(c[f"kernel.banded.{k}.launches"]) for k in ("gapped", "ungapped")}
    log(f"[phase 6a] cascade (threshold {CASCADE_THRESHOLD}) on {len(seqdb)} sequences on CUDA, in process "
        f"(from {started:.1f} s to {clock():.1f} s on the script's clock, beside 6e and "
        f"phase 5's CUDA run): {seconds:.2f} s ({ctx['smi']}); canopy reps {int(c['cascade.reps'])}, verify pairs "
        f"{int(c['cascade.verify_pairs'])}, verified {int(c['cascade.verified'])}, rep-round pairs "
        f"{int(c['cascade.rep_pairs'])}, edges {int(c['cascade.rep_edges'])}, empirical null fitted "
        f"{int(c['cascade.empirical_null_fitted'])}; {n_clusters} clusters, purity {purity:.4f} "
        f"(floor {PURITY_FLOOR}); kernel launches {launches}, banded {banded_launches}; align.seconds "
        f"{c['align.seconds']:.2f}, "
        f"rescore.seconds {c['rescore.seconds']:.2f}, banded.seconds {c.get('banded.seconds', 0.0):.2f}")
    check(launches["gapped"] > 0 and launches["ungapped"] > 0, f"the cascade did not launch both modes: {launches}")
    check_banded_route(c, {f"banded.{k}": v for k, v in banded_launches.items()}, "6a")
    check(purity >= PURITY_FLOOR, f"cascade purity {purity:.4f} < {PURITY_FLOOR}")
    record_span("phase 6a", started, clock())
    return dict(seconds=seconds, launches=launches, purity=purity, clusters=n_clusters)


def phase_side(ctx, work, config):
    """The side thread beside phase 5's CUDA run: 6a, the checks of 2c and
    3b, 6e (`config`, started with the run) and 2d; returns 2c's and 2d's
    errors and 3b's inputs of phase_nw_times."""
    phase_cascade(ctx, work)
    with span("phase 2c"):
        max_err = phase_dirbits_exact(ctx)
    with span("phase 3b, checks"):
        nw = phase_nw(ctx)
    with span("phase 6e"):
        finish_config(ctx, config)
    with span("phase 2d"):
        max_err.update(phase_i16_exact(ctx))
    return max_err, nw


def start_config(work, cores):
    """Phase 6e, start: `config --check` on the card with a fresh HOME, a
    process of its own on `cores`, registered in _RUNNING; returns (the
    process, watch_exit's record of it)."""
    env = dict(os.environ, HOME=os.path.join(work, "home_config"),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("UNICORE_TPU_TORCH_DEVICE", None)
    with _RUNNING_LOCK:
        check(not _STOPPED.is_set(), "6e: the run is stopping")
        proc = subprocess.Popen([sys.executable, "-m", "unicore_tpu_torch", "config", "--check"], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                preexec_fn=lambda: os.sched_setaffinity(0, cores))
        _RUNNING.add(proc)
    return proc, watch_exit(proc)


def finish_config(ctx, started):
    """Phase 6e, end: exit 0, CUDA with one device and the card's name,
    every engine ok but mmseqs."""
    import torch

    proc, watched = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        with _RUNNING_LOCK:
            _RUNNING.discard(proc)
    record_exit("phase 6e, config --check's process", watched, "config")
    check(proc.returncode == 0, f"config --check exited {proc.returncode}:\n{out[-2000:]}\n{err[-2000:]}")
    lines = out.splitlines()
    check("  cuda available: True, devices: 1, engines run on: cuda" in lines, f"config --check: {out}")
    check(f"    cuda:0 {torch.cuda.get_device_name(0)}" in lines, f"config --check names no card: {out}")
    for name in CHECKABLE:
        check(any(line.startswith(f"  {name}: ok (") for line in lines), f"config --check: {name} not ok")
    check("  mmseqs: no" in lines, "config --check: mmseqs not reported 'no'")
    log(f"[phase 6e] config --check on CUDA: exit 0 ({ctx['smi']}); "
        + "; ".join(line.strip() for line in lines if line.startswith("  ")))


def phase_cross6(ctx, work, cuda_run, cpu_times, cpu_counters):
    """Phases 6b and 6d, CUDA (`cuda_run`: the times and counters of phase
    5's CUDA run with cascade_steps and genetree_steps) against the CPU
    (run inside phase 5's CPU run): the cascade's clust.tsv byte-identical
    (its canopy merged some sequences, its representative round ran), the
    gene trees compared after parsing as phase 5 compares its trees."""
    times, counters = cuda_run
    tsv = [open(os.path.join(work, f"casc_{d}", "cluster", "clust.tsv"), "rb").read() for d in ("cpu", "cuda")]
    check(tsv[0] == tsv[1], "the cascade's clust.tsv differs between CUDA and the CPU")
    cc, cg = cpu_counters["cascade_cpu"], counters["cascade_cuda"]
    check(cc.get("kernel.sw.gapped.launches", 0) == 0 and cg["kernel.sw.gapped.launches"] > 0,
          "6b: the kernel ran on the wrong side")
    check(0 < cg["cascade.reps"] < cg["cluster.sequences"] and cg["cluster.sequences"] > CROSS_CASCADE_THRESHOLD
          and cg["cascade.rep_pairs"] > 0, "6b did not take the cascade, merge in its canopy and run its rep round")
    genes = core_genes(os.path.join(work, "x_cuda"))[:CROSS_GENETREE_GENES]
    a, b = read_files(os.path.join(work, "gt_cpu")), read_files(os.path.join(work, "gt_cuda"))
    n_inf = check_same_files(a, b)
    check(n_inf == 3 * len(genes), f"6d compared {n_inf} inference outputs for {len(genes)} genes")
    check_gene_trees(os.path.join(work, "gt_cuda"), genes)
    log(f"[phase 6b] cascade (threshold {CROSS_CASCADE_THRESHOLD}) at {CROSS_SPECIES} x {CROSS_CASCADE_PER_SPECIES}: "
        f"clust.tsv byte-identical CUDA vs CPU ({tsv[0].count(b'\n')} lines, {int(cg['cluster.clusters'])} clusters, "
        f"canopy reps {int(cg['cascade.reps'])}, rep-round pairs {int(cg['cascade.rep_pairs'])}); "
        f"CUDA {times['cascade_cuda']:.2f} s, CPU {cpu_times['cascade_cpu']:.2f} s ({ctx['smi']})")
    log(f"[phase 6d] gene-tree (iqtree defaults) on {len(genes)} core genes of phase 5: {n_inf} inference "
        f"outputs within tolerance CUDA vs CPU; CUDA {times['genetree_cuda']:.2f} s, CPU "
        f"{cpu_times['genetree_cpu']:.2f} s ({ctx['smi']})")


def phase_cross7(ctx, work, cuda_run, cpu_times, cpu_counters):
    """Phases 7b and 7c, CUDA (`cuda_run`) against the CPU (inside phase
    5's CPU run): easy-search's files before inference byte-identical and
    its tree files compared as phase 5 compares them; `tree -p`'s outputs
    compared the same way, with n_partitions the partition file's line
    count."""
    times, counters = cuda_run
    a, b = read_files(os.path.join(work, "es_cpu")), read_files(os.path.join(work, "es_cuda"))
    n_inf = check_same_files(a, b)
    for want in ("search/search.m8", "profile/copiness.tsv", "tree/combined.fasta",
                 "tree/combined.fasta.partitions", "tree/iqtree.treefile"):
        check(want in a, f"7b wrote no {want}")
    check(n_inf == 3 and a["search/search.chk"] == b"1" and a["tree/tree.chk"] == b"1",
          f"7b: {n_inf} inference outputs, search.chk {a['search/search.chk']}, tree.chk {a['tree/tree.chk']}")
    ce, cc = counters["easy_search_cuda"], cpu_counters["easy_search_cpu"]
    check(ce["kernel.sw.gapped.launches"] > 0 and cc.get("kernel.sw.gapped.launches", 0) == 0,
          "7b: the kernel ran on the wrong side")
    genes = [n[len("profile/"):-4] for n in a if n.startswith("profile/") and n.endswith(".txt")]
    m8 = a["search/search.m8"].decode().splitlines()
    log(f"[phase 7b] easy-search (defaults, iqtree -B 1000) at {CROSS_SPECIES} x {CROSS_PER_SPECIES} against "
        f"{len(core_genes(os.path.join(work, 'x_cuda')))} references: {len(a)} files, {len(a) - n_inf} "
        f"byte-identical CUDA vs CPU, {n_inf} inference outputs within tolerance; {len(m8)} hits, {len(genes)} "
        f"core genes; traceback windows batched {int(ce['traceback.batched'])}, banded "
        f"{int(ce.get('traceback.banded', 0))}, full {int(ce.get('traceback.full', 0))}; CUDA "
        f"{times['easy_search_cuda']:.2f} s, CPU {cpu_times['easy_search_cpu']:.2f} s ({ctx['smi']})")
    a, b = read_files(os.path.join(work, "tp_cpu")), read_files(os.path.join(work, "tp_cuda"))
    n_inf = check_same_files(a, b)
    n_parts = len(a["combined.fasta.partitions"].decode().splitlines())
    report = report_lines(b["iqtree.iqtree"])
    check(n_inf == 3 and b["tree.chk"] == b"1", f"7c: {n_inf} inference outputs, tree.chk {b['tree.chk']}")
    check(int(report["n_partitions"]) == n_parts, f"7c: n_partitions {report['n_partitions']}, file {n_parts}")
    cp = counters["tree_partitioned_cuda"]
    log(f"[phase 7c] tree {PARTITION_OPTIONS.format('combined.fasta.partitions')} on phase 5's supermatrix "
        f"({report['n_taxa']} taxa, {report['n_sites']} sites, {n_parts} partitions, {report['n_patterns']} "
        f"patterns): the same tree CUDA vs CPU within tolerance, lnL {float(report['lnL']):.4f}; Adam steps "
        f"{int(cp['phylo.blen_steps'])}, topologies scored {int(cp['phylo.candidates'])}; CUDA "
        f"{times['tree_partitioned_cuda']:.2f} s, CPU {cpu_times['tree_partitioned_cpu']:.2f} s ({ctx['smi']})")


def solo_infer(msa_path, out_json):
    """TreeEngine("fasttree").infer(-gamma) of one gene MSA, its tree, lnL
    and pattern count written to `out_json` (6c's solo side, run as its
    own process beside the lockstep run)."""
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo.engine import TreeEngine
    from unicore_tpu_torch.runtime import logging as msg
    from unicore_tpu_torch.runtime import profiling

    msg.set_verbosity(2)
    tree, ll, info = TreeEngine("fasttree").infer(read_fasta(msa_path), options="-gamma")
    with open(out_json, "w") as f:
        json.dump({"newick": tree.to_newick(), "lnL": ll, "n_patterns": info["n_patterns"]}, f)
    profiling.dump(os.environ["UNICORE_TPU_TORCH_COUNTERS"], {})


def lockstep_group(out_dir, what):
    """The first two core genes of `out_dir` (in name order) to share a
    (taxa, pattern bucket) lockstep group: (group, genes, {gene: key},
    their filtered MSA files)."""
    tree_dir = os.path.join(out_dir, "tree")
    genes = core_genes(out_dir)
    keys = {g: gene_key(os.path.join(tree_dir, "fasta", g, f"{g}.fa.filtered")) for g in genes}
    groups = {}
    for g in genes:  # in name order: the first group to reach two genes is the one taken
        groups.setdefault(keys[g][:2], []).append(g)
    first = next((k for k, v in groups.items() if len(v) >= 2), None)
    check(first is not None, f"no two of {what}'s {len(genes)} core genes share a lockstep group")
    grouped = groups[first][:2]
    return first, grouped, keys, [os.path.join(tree_dir, "fasta", g, f"{g}.fa.filtered") for g in grouped]


def lockstep_infer(msa_paths, out_json):
    """TreeEngine("fasttree").infer_batched(-gamma) of one lockstep
    group's gene MSAs, each gene's tree, lnL and pattern count and the
    call's seconds written to `out_json` (6c's lockstep side, run as its
    own process beside gene-tree)."""
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo.engine import TreeEngine
    from unicore_tpu_torch.runtime import logging as msg
    from unicore_tpu_torch.runtime import profiling

    msg.set_verbosity(2)
    t0 = time.perf_counter()
    res = TreeEngine("fasttree").infer_batched([read_fasta(m) for m in msa_paths], options="-gamma")
    seconds = time.perf_counter() - t0
    with open(out_json, "w") as f:
        json.dump({"seconds": seconds, "genes": [{"newick": t.to_newick(), "lnL": ll, "n_patterns": info["n_patterns"]}
                                                 for t, ll, info in res]}, f)
    profiling.dump(os.environ["UNICORE_TPU_TORCH_COUNTERS"], {})


def phase_genetree(ctx, work):
    """Phase 6c: gene-tree with its defaults on GENETREE_GENES core genes
    of phase 4's output, the first two (in name order) to share a (taxa,
    pattern bucket) group, and the lockstep inference (fasttree schedule,
    -gamma, a process of its own) of such a group of phase 5's CUDA
    output (5 taxa) against a solo inference of
    each gene (one process each).  gene-tree runs in this process (the
    CLI's entry, cli_chain), the solo runs and the lockstep run beside it,
    on cores of their own; a mismatch prints both trees."""
    from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance

    out_dir = os.path.join(work, "main")
    tree_dir = os.path.join(out_dir, "tree")
    first, grouped4, keys4, msa_files4 = lockstep_group(out_dir, "phase 4")
    picked = grouped4[:GENETREE_GENES]
    names = os.path.join(work, "genetree_names.txt")
    with open(names, "w") as f:
        f.write("".join(g + "\n" for g in picked))
    keep = os.path.join(work, "solo")
    os.makedirs(keep, exist_ok=True)
    lock_group, grouped, keys, msa_files = lockstep_group(os.path.join(work, "x_cuda"), "phase 5")
    cores = sorted(os.sched_getaffinity(0))
    timed, others = set(cores[:2]), set(cores[2:]) or set(cores)
    lock_json = os.path.join(keep, "lockstep.json")
    sides = [("lockstep", ["-c", f"import chip_smoke as c; c.lockstep_infer({msa_files!r}, {lock_json!r})"])]
    sides += [(f"solo_{g}", ["-c", f"import chip_smoke as c; c.solo_infer({m!r}, "
                                   f"{os.path.join(keep, g + '.solo.json')!r})"]) for g, m in zip(grouped, msa_files)]
    with ThreadPoolExecutor(len(sides)) as pool:
        side_runs = [pool.submit(_on_cores, others, run_steps, [step], keep, os.path.join(work, "home_main"))
                     for step in sides]
        every_core = os.sched_getaffinity(0)
        os.sched_setaffinity(0, timed)
        try:
            cli_chain([("gene-tree", ["gene-tree", tree_dir, "--name", names])], out_dir, "genetree_chain")
        finally:
            os.sched_setaffinity(0, every_core)
        for f in side_runs:
            f.result()
    times = json.load(open(os.path.join(out_dir, "genetree_chain.times.json")))
    c = json.load(open(os.path.join(out_dir, "gene-tree.counters.json")))
    lock = json.load(open(lock_json))
    batched = [(parse_newick(x["newick"]), x["lnL"], x) for x in lock["genes"]]
    reports = check_gene_trees(tree_dir, picked)
    check(int(c["phylo.genes"]) == len(picked), f"gene-tree inferred {c['phylo.genes']} genes")
    per_gene = times["gene-tree"] / len(picked)
    log(f"[phase 6c] gene-tree (iqtree -m JTT+F+I+G -B 1000) on {len(picked)} core genes of phase 4 "
        f"({', '.join(f'{g}: {keys4[g][0]} taxa, {keys4[g][2]} patterns' for g in picked)}; lockstep group "
        f"{first} holds {grouped4}): {times['gene-tree']:.2f} s of the CLI call in this process, {per_gene:.2f} s "
        f"per gene "
        f"({ctx['smi']}; beside the lockstep check on other cores); phylo.seconds {c['phylo.seconds']:.2f}, "
        f"groups {int(c['phylo.gene_groups'])}, Adam steps {int(c['phylo.blen_steps'])} "
        f"({c['phylo.blen_steps'] / len(picked):.0f} per gene), topologies scored {int(c['phylo.candidates'])}; "
        f"lnL " + ", ".join(f"{g} {float(reports[g]['lnL']):.4f}" for g in picked))
    bad = []
    for g, (bt, bll, binfo) in zip(grouped, batched):
        s = json.load(open(os.path.join(keep, g + ".solo.json")))
        rf = rf_distance(bt, parse_newick(s["newick"]))
        a, b = tree_edges(s["newick"]), tree_edges(binfo["newick"])
        loose = {k: (a.get(k) or b.get(k))[0] for k in set(a) ^ set(b)}
        log(f"  lockstep vs solo (fasttree -gamma, CUDA) {g}: RF {rf} (splits in one tree only, with their "
            f"branch lengths: {({'+'.join(sorted(k)): v for k, v in loose.items()})}), lnL {bll:.4f} vs "
            f"{s['lnL']:.4f}, n_patterns {binfo['n_patterns']} vs {s['n_patterns']}")
        if any(v > RESOLVED for v in loose.values()) or abs(bll - s["lnL"]) > SOLO_LL_RTOL * abs(s["lnL"]) \
                or not binfo["n_patterns"] == s["n_patterns"] == keys[g][2]:
            bad.append(f"{g}: lockstep {binfo['newick']} solo {s['newick']}")
    log(f"  lockstep inference of phase 5's group {lock_group} ({', '.join(grouped)}), a process of its own: "
        f"{lock['seconds']:.2f} s ({ctx['smi']})")
    check(not bad, "6c: lockstep and solo inference differ: " + "; ".join(bad))
    phase6_op_times(ctx, msa_files4)
    return dict(seconds=times["gene-tree"], per_gene=per_gene)


def write_prostt5_checkpoint(path, n_layers, seed):
    """A synthetic ProstT5 checkpoint in the real HF layout
    (synthetic.prostt5_hf_tensors) at ProtT5-XL's width (T5Config():
    d_model 1024, 32 heads x 128, d_ff 16384, relu) with `n_layers`
    layers, config.json and added_tokens.json.  Weights are drawn on the
    card from a seeded torch.Generator and saved as float16
    pytorch_model.bin; returns the seconds it took."""
    import torch

    from unicore_tpu_torch.models.prostt5 import T5Config
    from unicore_tpu_torch.synthetic import prostt5_hf_tensors, write_prostt5_json

    t0 = time.perf_counter()
    cfg = dataclasses.replace(T5Config(), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, scale, shift):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale + shift).half().cpu()

    sd = prostt5_hf_tensors(cfg, draw)
    write_prostt5_json(path, cfg, PROSTT5_PREFIX)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return time.perf_counter() - t0


def prostt5_bound(cfg, n_params, B, L):
    """(bound_ms, ops_ms, bytes_ms, flops) of one forward (encoder and
    head) of a (B, L) batch: flops of the q/k/v/o and FFN products,
    q·kᵀ and probs·v and the two convolutions over the data sheet's
    dense bf16 rate; bytes of the weights (bf16) read once, the residual
    stream read and written once per layer, tokens and mask read and the
    codes written, over 3.35 TB/s."""
    D, F, H, dk = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_kv
    per_layer = 2 * B * L * (4 * D * H * dk + 2 * D * F) + 4 * B * H * L * L * dk
    head = 2 * B * L * cfg.cnn_kernel * (D * cfg.cnn_hidden + cfg.cnn_hidden * cfg.n_classes)
    flops = cfg.n_layers * per_layer + head
    nbytes = 2 * n_params + cfg.n_layers * 2 * B * L * D * 2 + B * L * (8 + 1 + 8)
    ops_ms, bytes_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms, flops


def _random_aa(rng, n):
    return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))


def phase_prostt5(ctx, work):
    """Phase 8a: `createdb` with a ProstT5 model directory at ProtT5-XL's
    full width on the card, through the CLI (a subprocess, so its load
    and its peak memory are its own): a synthetic 24-layer checkpoint
    (write_prostt5_checkpoint) and PROSTT5_SPECIES proteomes of phase 4's
    seed plus one 5,000-residue protein (the windowed path).  Every 3Di string has its
    protein's length and only 3Di letters.  Then, in process, full batches
    at PROSTT5_BUCKETS: ms per batch of encoder_forward, cnn_head and the
    encoder and head (CUDA events; predict_3di_codes adds an argmax),
    peak memory, and the bound."""
    import torch

    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.alphabets import TDI_ALPHABET
    from unicore_tpu_torch.io.seqdb import read_db
    from unicore_tpu_torch.models import prostt5 as P

    ckpt = os.path.join(work, "prostt5")
    write_s = write_prostt5_checkpoint(ckpt, P.T5Config().n_layers, PROSTT5_SEED)
    in_dir = os.path.join(work, "prostt5_in")
    synthetic.write_proteomes(in_dir, PROSTT5_SPECIES, PER_SPECIES, seed=7)
    with open(os.path.join(in_dir, "long.fa"), "w") as f:
        f.write(">long_protein\n" + _random_aa(np.random.RandomState(8), LONG_PROTEIN) + "\n")
    want = set()
    for fn in os.listdir(in_dir):
        want |= {l.strip() for l in open(os.path.join(in_dir, fn)) if not l.startswith(">") and len(l.strip()) >= 2}
    out_dir = os.path.join(work, "prostt5_out")
    db = os.path.join(out_dir, "proteome", "proteome_db")
    times, counters = run_steps([("createdb_prostt5", ["createdb", in_dir, db, ckpt])], out_dir,
                                os.path.join(work, "home_main"))
    c = counters["createdb_prostt5"]
    aa, ss = read_db(db), read_db(db + "_ss")
    check(sorted(aa) == sorted(want), f"createdb wrote {len(aa)} sequences, the inputs hold {len(want)}")
    bad = [i for i, (a, s) in enumerate(zip(aa, ss)) if len(a) != len(s) or not set(s) <= set(TDI_ALPHABET)]
    check(len(ss) == len(aa) and not bad, f"3Di strings of the wrong length or alphabet: {bad[:5]}")
    check(LONG_PROTEIN in {len(a) for a in aa}, "the long protein is missing")
    pred = c["prostt5.predict.seconds"]
    log(f"[phase 8a] createdb with a 24-layer ProtT5-XL-width checkpoint (written in {write_s:.1f} s) on "
        f"{len(aa)} sequences ({sum(map(len, aa))} residues, one of {LONG_PROTEIN}) on CUDA: "
        f"{times['createdb_prostt5']:.2f} s of subprocess wall, stage.createdb.seconds "
        f"{c['stage.createdb.seconds']:.2f}, load {c['prostt5.load.seconds']:.2f} s, predict {pred:.2f} s in "
        f"{int(c['prostt5.batches'])} batches; {c['prostt5.residues'] / pred:.0f} residues/s, "
        f"{c['prostt5.padded_tokens'] / pred:.0f} padded tokens/s ({int(c['prostt5.padded_tokens'])} tokens); "
        f"peak memory {c['prostt5.peak_bytes'] / 2**30:.2f} GiB ({ctx['smi']})")

    eng = P.ProstT5Engine(ckpt)
    check(eng.loaded_pretrained and eng.device.type == "cuda", "the engine did not load the checkpoint on the card")
    n_params = sum(p.numel() for p in eng.model.parameters())
    rng = np.random.RandomState(9)
    log("[phase 8a] bucket batch | ms per batch: encoder_forward, cnn_head, both | bound ms "
        "(ops, bytes) | share of bound | peak GiB")
    rows = {}
    for L in PROSTT5_BUCKETS:
        B = max(8, min(512, eng.batch_tokens // L))
        toks, mask = P.frame_batch([_random_aa(rng, L - 2) for _ in range(B)], L)
        tg, mg = torch.from_numpy(toks).to(eng.device), torch.from_numpy(mask).to(eng.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        enc_ms = time_cuda(lambda: P.encoder_forward(eng.model, tg, mg), PROSTT5_REPS)
        h = P.encoder_forward(eng.model, tg, mg)
        res = (tg < P.TOK_PREFIX) & mg
        head_ms = time_cuda(lambda: P.cnn_head(eng.model, h, res), 10)
        del h
        full_ms = enc_ms + head_ms
        peak = torch.cuda.max_memory_allocated() / 2**30
        bound, ops_ms, bytes_ms, _ = prostt5_bound(eng.cfg, n_params, toks.shape[0], L)
        rows[L] = dict(B=toks.shape[0], enc_ms=enc_ms, head_ms=head_ms, ms=full_ms, bound_ms=bound, peak=peak)
        log(f"  {L:5d} {toks.shape[0]:4d} | {enc_ms:9.2f} {head_ms:7.3f} {full_ms:9.2f} | {bound:8.2f} "
            f"({ops_ms:.2f}, {bytes_ms:.3f}) | {bound / full_ms:6.1%} | {peak:.2f}")
    log(f"  {n_params} parameters; bound = max(flops / {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16, "
        f"bytes / 3.35 TB/s), data sheet peaks ({ctx['smi']})")
    check(rows[2176]["peak"] < 40, f"peak memory {rows[2176]['peak']:.1f} GiB at bucket 2,176 (budget 40 GiB)")
    del eng
    torch.cuda.empty_cache()
    return rows


def prostt5_profile(ctx, work, buckets=(384, 2176)):
    """Where a full batch's encoder_forward spends the card's time, by
    kernel (not run by main(); by hand after phase_env):

        python3 -c "import chip_smoke as c, tempfile; c.prostt5_profile(c.phase_env(), tempfile.mkdtemp())"

    Writes phase 8a's 24-layer checkpoint, then for each bucket profiles
    one encoder_forward of a full batch (device_busy_ms) and prints the
    wall ms, the device-busy ms, and the PROFILE_TOP kernels by device
    time (their launches and ms)."""
    import torch

    from unicore_tpu_torch.models import prostt5 as P

    ckpt = os.path.join(work, "prostt5")
    write_prostt5_checkpoint(ckpt, P.T5Config().n_layers, PROSTT5_SEED)
    eng = P.ProstT5Engine(ckpt)
    rng = np.random.RandomState(9)
    for L in buckets:
        B = max(8, min(512, eng.batch_tokens // L))
        toks, mask = P.frame_batch([_random_aa(rng, L - 2) for _ in range(B)], L)
        tg, mg = torch.from_numpy(toks).to(eng.device), torch.from_numpy(mask).to(eng.device)
        P.encoder_forward(eng.model, tg, mg)
        busy, wall_ms, by_name = device_busy_ms(lambda: P.encoder_forward(eng.model, tg, mg), by_name=True)
        log(f"[prostt5 profile] bucket {L}, batch {toks.shape[0]}: encoder_forward {wall_ms:.1f} ms of wall, "
            f"the card busy {busy:.1f} ms, {sum(n for n, _ in by_name.values())} device events ({ctx['smi']})")
        for name, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:PROFILE_TOP]:
            log(f"  {ns / 1e6:9.2f} ms {n:6d} x  {name[:110]}")


@contextlib.contextmanager
def low_precision_requested():
    """Every lower-precision setting a caller could leave on: TF32 in
    cuBLAS (tf32_requested) and cuDNN, bf16 split-K reductions; the
    ProstT5 model's guard is what keeps them out.  Restored afterwards."""
    import torch

    mm = torch.backends.cuda.matmul
    prev = (torch.backends.cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        with tf32_requested():
            yield
            check(torch.get_float32_matmul_precision() == "high" and torch.backends.cudnn.allow_tf32
                  and mm.allow_bf16_reduced_precision_reduction, "the model did not restore the caller's settings")
    finally:
        torch.backends.cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction = prev


def check_3di_ties(seqs, ref, got, lg, what):
    """`got` 3Di strings against `ref` under the tie rule of
    tests/torch_port_helpers.py: every differing letter where `lg` (the
    reference's framed logits, one row per sequence) has a top-two gap
    below TIE_RTOL_BF16 of its largest |logit|, and at least MIN_AGREE of
    the letters equal.  Returns (letters differing, letters, widest gap)."""
    n_diff = n_all = 0
    widest = 0.0
    for i, (s, r, g) in enumerate(zip(seqs, ref, got)):
        check(len(r) == len(g) == len(s), f"{what}: 3Di length of sequence {i}")
        diff = [p for p in range(len(s)) if r[p] != g[p]]
        n_diff, n_all = n_diff + len(diff), n_all + len(s)
        top = np.sort(lg[i, 1:len(s) + 1][diff], axis=-1)
        gaps = (top[:, -1] - top[:, -2]) / np.abs(lg[i, 1:len(s) + 1]).max()
        widest = max([widest, *gaps])
        check(np.all(gaps < TIE_RTOL_BF16), f"{what}: differ off a tie: sequence {i} at {diff}")
    check(n_diff <= (1 - MIN_AGREE) * n_all, f"{what}: {n_diff} of {n_all} letters differ")
    return n_diff, n_all, widest


def phase_prostt5_cross(ctx, work):
    """Phase 8b: the model at ProtT5-XL's width with 2 of its 24 layers (a
    checkpoint of its own, config.json num_layers 2) on the card against
    the CPU, with every lower-precision setting on: hidden states and
    logits in float32 within PROSTT5_RTOL, and the bf16 engines' 3Di on
    CROSS_PROSTT5_SEQS sequences of 30-120 residues (one bucket) under the
    tie rule, and their logits within BF16_SPREAD of the CPU's bf16
    rounding (RMS distances: CUDA from CPU bf16, CPU bf16 from CPU
    float32)."""
    import torch

    from unicore_tpu_torch.models import prostt5 as P

    t0 = time.perf_counter()
    ckpt = os.path.join(work, "prostt5_cross")
    write_prostt5_checkpoint(ckpt, CROSS_PROSTT5_LAYERS, PROSTT5_SEED + 1)
    cfg = P.infer_config(ckpt)
    rng = np.random.RandomState(10)
    seqs = [_random_aa(rng, n) for n in rng.randint(30, 121, CROSS_PROSTT5_SEQS)]
    toks, mask = P.frame_batch(seqs, P._bucket_len(max(map(len, seqs)) + 2))
    res = (toks < P.TOK_PREFIX) & mask
    err = {}

    def rel(ref, got, sel):
        ref, got = np.asarray(ref, np.float64)[sel], np.asarray(got, np.float64)[sel]
        return float(np.max(np.abs(got - ref) / (PROSTT5_RTOL * (np.abs(ref) + np.abs(ref).max()))))

    with low_precision_requested():
        state = P.load_params(ckpt, cfg, dtype=torch.float32)
        cpu, gpu = P.build_model(cfg, state, "cpu"), P.build_model(cfg, state, ctx["dev"])
        del state
        tc, mc = torch.from_numpy(toks), torch.from_numpy(mask)
        tg, mg = tc.to(ctx["dev"]), mc.to(ctx["dev"])
        err["hidden states"] = rel(P.encoder_forward(cpu, tc, mc), P.encoder_forward(gpu, tg, mg).cpu(), mask)
        lg32 = P.residue_logits(cpu, tc, mc).numpy()
        err["logits"] = rel(lg32, P.residue_logits(gpu, tg, mg).cpu(), res)
        del cpu, gpu
        e_cpu, e_gpu = P.ProstT5Engine(ckpt, device="cpu"), P.ProstT5Engine(ckpt, device=ctx["dev"])
        ref, got = e_cpu.predict(seqs), e_gpu.predict(seqs)
        lg = P.residue_logits(e_cpu.model, tc, mc).numpy()
        lg_gpu = P.residue_logits(e_gpu.model, tg, mg).cpu().numpy()
    max_dev = float(np.abs(lg_gpu[res] - lg[res]).max() / np.abs(lg[res]).max())
    d_gpu, d_f32 = (np.asarray(d, np.float64) for d in (lg_gpu[res] - lg[res], lg[res] - lg32[res]))
    spread = float(np.sqrt(np.mean(d_gpu ** 2) / np.mean(d_f32 ** 2)))
    n_diff, n_all, widest = check_3di_ties(seqs, ref, got, lg, "bf16 3Di CUDA vs CPU")
    check(spread <= BF16_SPREAD, f"bf16 logits CUDA vs CPU: {spread:.3g} of the CPU's bf16 rounding "
          f"(limit {BF16_SPREAD})")
    for name, e in err.items():
        check(e <= 1.0, f"ProstT5 on CUDA != CPU: {name} at {e:.3g} of the tolerance")
    log(f"[phase 8b] ProstT5 at full width, {CROSS_PROSTT5_LAYERS} of 24 layers, CUDA vs CPU with TF32 and bf16 "
        f"reductions requested, {len(seqs)} sequences at bucket {toks.shape[1]}: float32 errors as a share of "
        f"rtol {PROSTT5_RTOL} + atol {PROSTT5_RTOL} max|ref|: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f"; bf16 logits {spread:.3g} of the CPU's bf16 rounding (limit {BF16_SPREAD}), at most {max_dev:.3g} "
        f"of max|logit|; 3Di {n_all - n_diff} "
        f"of {n_all} letters equal (the rest ties, widest gap {widest:.3g} of max|logit|, limit {TIE_RTOL_BF16:.3g}); "
        f"{time.perf_counter() - t0:.1f} s")
    return err


# ---------------------------------------------------------------------------
# phase 9: the multi-device paths
# ---------------------------------------------------------------------------

def logical_mesh(dev, n=LOGICAL_SHARDS):
    """A 1-D mesh of `n` shards of one card: the multi-device code paths,
    their shards one after another on that card."""
    from unicore_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * n, dp=n, tp=1)


@contextlib.contextmanager
def local_mesh_is(mesh):
    """parallel.mesh.local_mesh patched to give `mesh` (None: no mesh) to
    callers on CUDA, as it gives every card on a machine with several;
    restored after."""
    import torch

    from unicore_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.local_mesh
    mesh_mod.local_mesh = lambda device=None: (
        mesh if device is not None and torch.device(device).type == "cuda" else None)
    try:
        yield
    finally:
        mesh_mod.local_mesh = real


def phase_sharded_sw(ctx, mesh):
    """Phase 9a: sw_forward_sharded on `mesh` (and over every card where
    there are several) against one sw_forward_cuda call and the plain
    version, bit-exact on (best, qend, tend): at KERNEL_SHAPE gapped with
    gap_window 64 and bias on (the engine's), gapped with gap_window 0
    and no bias, ungapped with bias, and RAGGED_B pairs padded as the
    engine pads.  Then its ms at KERNEL_SHAPE (the engine's setting) on
    `mesh` beside the single call's and the plain version's, and its
    bound: the shards' bounds summed over the distinct devices.  Returns
    the numbers of the kernel line's row."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain
    from unicore_tpu_torch.parallel import mesh as mesh_mod

    saa, s3d, dev = ctx["saa"], ctx["s3d"], ctx["dev"]
    meshes = [(f"{LOGICAL_SHARDS} shards of one card", mesh)]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", mesh_mod.local_mesh(dev)))
    else:
        log(f"[phase 9a] one card ({torch.cuda.device_count()}): the mesh over every card is not run")
    B, L = KERNEL_SHAPE
    settings = [("gapped", "on", B, dict(gap_window=64)), ("gapped", "off", B, dict(gap_window=0)),
                ("ungapped", "on", B, dict(ungapped=True)), ("gapped", "on", RAGGED_B, dict(gap_window=64))]
    max_err, n_cmp = 0.0, 0
    t0 = time.perf_counter()
    for name, m in meshes:
        nd = mesh_mod.n_shards(m)
        for kind, bias, B0, kw in settings:
            args, qc = sw_inputs(ctx["rng"], B0, L, bias, ctx["saa_np"], ctx["s3d_np"], dev)
            Bp = mesh_mod.round_up(B0, nd * 16)  # align/engine.py's padding
            pad = mesh_mod.pad_rows
            padded = [pad(x, Bp, v) for x, v in zip(args, (20, 20, 20, 20, 1, 1))]
            sh = sw_cuda.sw_forward_sharded(*padded, saa, s3d, m, qc=None if qc is None else pad(qc, Bp, 0), **kw)
            one = sw_cuda.sw_forward_cuda(*args, saa, s3d, qc=qc, **kw)
            plain = sw_forward_plain(*args, saa, s3d, qc=qc, **kw)
            torch.cuda.synchronize()
            sh = [x[:B0] for x in sh]
            max_err = max(max_err, float((sh[0] - plain[0]).abs().max()))
            check(all(torch.equal(a, b) for a, b in zip(sh, one)) and all(torch.equal(a, b) for a, b in zip(sh, plain)),
                  f"sw_forward_sharded on {name} != one call / plain at B={B0} L={L} {kind} bias={bias} {kw}")
            n_cmp += 1
    # times on the logical mesh, the engine's setting (phase 3's timed one)
    args, qc = sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], dev)
    kw = TIMED_MODES["gapped"]
    ms = time_cuda(lambda: sw_cuda.sw_forward_sharded(*args, saa, s3d, mesh, qc=qc, **kw), SHARDED_REPS)
    one_ms = time_cuda(lambda: sw_cuda.sw_forward_cuda(*args, saa, s3d, qc=qc, **kw), SHARDED_REPS)
    plain_ms = time_cuda(lambda: sw_forward_plain(*args, saa, s3d, qc=qc, **kw), 1)
    devices = mesh_mod.shard_devices(mesh)
    b = B // len(devices)
    ops_ms = bytes_ms = 0.0
    for k in range(len(devices)):
        _, o, by = bound_of(ctx, [x[k * b:(k + 1) * b] for x in args], qc[k * b:(k + 1) * b], "gapped")
        ops_ms, bytes_ms = ops_ms + o, bytes_ms + by
    n_distinct = len(set(devices))
    bound_ms = max(ops_ms, bytes_ms) / n_distinct
    log(f"[phase 9a] sw_forward_sharded bit-exact against one call and the plain version in {n_cmp} "
        f"comparisons ({', '.join(n for n, _ in meshes)}; gapped w64 and w0, ungapped, bias on and off, "
        f"B {B} and {RAGGED_B} padded to {mesh_mod.round_up(RAGGED_B, LOGICAL_SHARDS * 16)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  at ({B}, {L}) gapped, gap_window 64, bias on: {ms:.4f} ms on {LOGICAL_SHARDS} shards of one card "
        f"({n_distinct} distinct device), one call {one_ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
        f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; {ctx['smi']})")
    return dict(ms=ms, one_ms=one_ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=max_err,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _band_pairs(rng, B, L, Lt=None):
    """B long pairs (query bucket L, target bucket Lt, default L): each
    target a shifted, mutated copy of its query (cut to Lt) with a short
    indel; d0 from the engine's diagonal vote."""
    from unicore_tpu_torch.ops.banded import vote_diagonal

    Lt = L if Lt is None else Lt
    qa, qs = (np.full((B, L), 20, np.int32) for _ in range(2))
    ta, ts = (np.full((B, Lt), 20, np.int32) for _ in range(2))
    ql, tl, d0 = np.ones(B, np.int32), np.ones(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(L // 2, L - 64)
        a, s = rng.randint(0, 20, n).astype(np.int32), rng.randint(0, 20, n).astype(np.int32)
        shift = rng.randint(0, 40)
        t_a = np.concatenate([rng.randint(0, 20, shift), a]).astype(np.int32)
        t_s = np.concatenate([rng.randint(0, 20, shift), s]).astype(np.int32)
        sub = rng.randint(shift, len(t_a), n // 8)
        t_a[sub] = rng.randint(0, 20, len(sub))
        cut = rng.randint(shift + 20, len(t_a) - 20)
        t_a, t_s = np.delete(t_a, slice(cut, cut + 3)), np.delete(t_s, slice(cut, cut + 3))
        t_a, t_s = t_a[:Lt], t_s[:Lt]
        ql[b], tl[b] = n, len(t_a)
        qa[b, :n], qs[b, :n], ta[b, :len(t_a)], ts[b, :len(t_s)] = a, s, t_a, t_s
        d0[b] = vote_diagonal(a, s, t_a, t_s) or 0
    qc = rng.randint(-60, 40, (B, L)).astype(np.int32)
    return qa, qs, ta, ts, ql, tl, d0, qc


def phase_sharded_banded_nw(ctx, mesh):
    """Phase 9b: sw_forward_banded_sharded (gapped with gap_window 64 and
    ungapped, bias on) and nw_forward_bits_sharded on `mesh`, each
    bit-identical to one call of its single-device function on the card."""
    import torch

    from unicore_tpu_torch.ops import banded, banded_cuda, dirbits_cuda, nw_device
    from unicore_tpu_torch.synthetic import nw_scores

    t0 = time.perf_counter()
    dev, saa, s3d = ctx["dev"], ctx["saa"], ctx["s3d"]
    B, L, W = BANDED_9B
    arrays = [torch.from_numpy(x).to(dev) for x in _band_pairs(ctx["rng"], B, L)]
    for kw in (dict(gap_window=64), dict(ungapped=True)):
        kind = "ungapped" if kw.get("ungapped") else "gapped"
        before = banded_cuda.LAUNCHES[kind]
        sh = banded.sw_forward_banded_sharded(*arrays[:7], saa, s3d, mesh, W=W, qc=arrays[7], **kw)
        check(banded_cuda.LAUNCHES[kind] - before == LOGICAL_SHARDS,
              f"9b: sw_forward_banded_sharded made {banded_cuda.LAUNCHES[kind] - before} kernel launches")
        one = banded.sw_forward_banded(*arrays[:7], saa, s3d, W=W, qc=arrays[7], **kw)  # plain, one call
        check(all(torch.equal(a, b) for a, b in zip(sh, one)), f"sw_forward_banded_sharded != one call, {kw}")
        check(float(one[0].max()) > 0, "9b: the banded pairs scored nothing")
    Bn, Ln = NW_9B
    S, l1, l2 = (torch.from_numpy(x).to(dev) for x in nw_scores(ctx["rng"], Bn, Ln, Ln, "rand"))
    before = dirbits_cuda.LAUNCHES["nw"]
    sh = nw_device.nw_forward_bits_sharded(S, l1, l2, 2816, 256, mesh)
    check(dirbits_cuda.LAUNCHES["nw"] - before == LOGICAL_SHARDS,
          f"9b: nw_forward_bits_sharded made {dirbits_cuda.LAUNCHES['nw'] - before} kernel launches")
    one = nw_device.nw_forward_bits(S, l1, l2, 2816, 256)  # plain, one call
    check(all(torch.equal(a, b) for a, b in zip(sh, one)), "nw_forward_bits_sharded != one call")
    torch.cuda.synchronize()
    log(f"[phase 9b] sw_forward_banded_sharded ({B} pairs, bucket {L}, W {W}; gapped and ungapped; one banded "
        f"kernel launch per shard) against one plain call, and nw_forward_bits_sharded ({Bn} pairs, bucket {Ln}; one "
        f"direction-bit kernel launch per shard) on {LOGICAL_SHARDS} shards bit-identical to one plain "
        f"call each in {time.perf_counter() - t0:.1f} s")


def phase_sharded_phylo(ctx, st, mesh):
    """Phase 9c, under TF32 settings: loglik_batch and site_loglik_batch of
    phase 3c's 64 candidates (20 taxa x 8,192 columns, JTT+F+I+G) with
    mesh= `mesh` against mesh=False, and _loglik_multi_sharded of
    GENES_9C genes of that width x CANDIDATES_9C candidates against one
    _loglik_multi_impl call, within SHARD_LL_RTOL + SHARD_LL_ATOL."""
    import torch

    from unicore_tpu_torch.phylo import genebatch as gb
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import models as tm
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.synthetic import simulate_msa

    t0 = time.perf_counter()
    gpu, cb, bb = st["gpu"], st["cb"], st["bb"]
    err = {}

    def rel(ref, got):
        ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
        check(ref.shape == got.shape, f"9c: shapes {ref.shape} != {got.shape}")
        return float(np.max(np.abs(got - ref) / (SHARD_LL_ATOL + SHARD_LL_RTOL * np.abs(ref))))

    with tf32_requested():
        err["loglik_batch"] = rel(gpu.loglik_batch(cb, bb, mesh=False), gpu.loglik_batch(cb, bb, mesh=mesh))
        err["site_loglik_batch"] = rel(gpu.site_loglik_batch(cb, bb, mesh=False),
                                       gpu.site_loglik_batch(cb, bb, mesh=mesh))
        msas = [simulate_msa(np.random.RandomState(PHYLO["seed"] + 1 + g), PHYLO["n"], PHYLO["L"])
                for g in range(GENES_9C)]
        bucket = max(gb.pattern_bucket(tl.compress_patterns(tl.msa_to_codes(list(m), list(m.values())))[0].shape[1])
                     for m in msas)
        engines, cbs, bbs = [], [], []
        for m in msas:
            names, seqs = list(m), list(m.values())
            model = tm.SubstModel.build(tm.ModelSpec.parse(PHYLO["model"]), alpha=PHYLO["alpha"],
                                        p_inv=PHYLO["p_inv"],
                                        empirical_freqs=tl.empirical_frequencies(tl.msa_to_codes(names, seqs)))
            engines.append(tl.LikelihoodEngine(names, seqs, model, device=ctx["dev"], pad_patterns_to=bucket))
            c, b = _nj_start(m, 1e-3)
            arr = [tl.tree_to_arrays(x, names) for x in ts.nni_neighbors(tl.arrays_to_tree(c, b, names))]
            cbs.append(np.stack([a[0] for a in arr[:CANDIDATES_9C]]))
            bbs.append(np.stack([a[1] for a in arr[:CANDIDATES_9C]]).astype(np.float32))
        keys = ("eigvals", "U", "Uinv", "pi", "rates", "props")
        mp = {k + "_g": torch.stack([e._mp[k] for e in engines]) for k in keys}
        tips, w = torch.stack([e.tips for e in engines]), torch.stack([e.w for e in engines])
        cgk, bgk = np.stack(cbs), np.stack(bbs)
        with tl.full_fp32(), torch.no_grad():
            one = gb._loglik_multi_impl(torch.from_numpy(cgk).to(ctx["dev"]), torch.from_numpy(bgk).to(ctx["dev"]),
                                        tips, w, **mp).cpu().numpy()
        err["_loglik_multi_sharded"] = rel(one, gb._loglik_multi_sharded(mesh, cgk, bgk, tips, w, mp))
        check(torch.get_float32_matmul_precision() == "high", "9c: the engine did not restore the matmul precision")
    for name, e in err.items():
        check(e <= 1.0, f"9c: {name} sharded != one device at {e:.3g} of the tolerance")
    log(f"[phase 9c] likelihood on {LOGICAL_SHARDS} shards vs one device under TF32 settings ({len(cb)} candidates; "
        f"{GENES_9C} genes x {CANDIDATES_9C} candidates at {PHYLO['n']} taxa x {bucket} patterns), errors as a share "
        f"of rtol {SHARD_LL_RTOL} + atol {SHARD_LL_ATOL}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f"; {time.perf_counter() - t0:.1f} s")


def start_ranks(n, args, what):
    """n processes of `python -m unicore_tpu_torch.parallel.dist_check
    --device cuda ARGS`, each a rank of one gloo group on this card (NCCL
    refuses two ranks on one card), brought up through
    initialize_distributed by the three variables and registered in
    _RUNNING; returns (the processes, their start)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, UNICORE_TPU_COORDINATOR=f"127.0.0.1:{port}",
               UNICORE_TPU_NUM_PROCS=str(n))
    procs = []
    with _RUNNING_LOCK:
        check(not _STOPPED.is_set(), f"{what}: the run is stopping")
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "unicore_tpu_torch.parallel.dist_check", "--device", "cuda", *map(str, args)],
                env=dict(env, UNICORE_TPU_PROC_ID=str(rank)), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            _RUNNING.add(procs[-1])
    return procs, time.perf_counter()


def finish_ranks(started, what, timeout=240):
    """Each rank's "OK ..." line once every rank has exited 0 (it checks
    its own results and raises otherwise); fails the phase where one
    did not."""
    procs, _ = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        with _RUNNING_LOCK:
            for p in procs:
                p.kill()
                _RUNNING.discard(p)
    lines = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        ok = [l for l in out.splitlines() if l.startswith(f"OK procs={len(procs)} backend=gloo")]
        check(p.returncode == 0 and ok, f"{what}: rank {rank} exited {p.returncode}:\n{out[-3000:]}")
        lines.append(ok[-1])
    return lines


def start_dist_check():
    """Phase 9e, start: DIST_RANKS ranks of dist_check's SW mode."""
    return start_ranks(DIST_RANKS, [], "9e")


def finish_dist_check(started):
    """Phase 9e, end: every rank exited 0 having checked the gathered
    results and the all-reduced hit count against its full local
    reference, on gloo, with one kernel launch on its block."""
    t0 = started[1]
    lines = finish_ranks(started, "9e")
    check(all("launches=1" in l for l in lines), f"9e: a rank did not launch the kernel once: {lines}")
    line = lines[0]
    log(f"[phase 9e] {DIST_RANKS} ranks through initialize_distributed (gloo, kernels on this card, collectives "
        f"on host copies): {line}; {time.perf_counter() - t0:.1f} s from their start")


def phase_sharded_engines(ctx, work, mesh):
    """Phase 9d: the engines' multi-device branches with local_mesh patched
    to `mesh`, against the same calls unpatched, on the card:
    AlignmentEngine.align_pairs on phase 4's first SHARD_SPECIES x 120
    sequences (prefilter pairs; the E-value fit made anew on each side,
    so the calibration goes through the branch too) with equal hits and
    equal fitted statistics; nw_align_batch on NW_MATRICES_9D score
    matrices with equal paths and scores; ProstT5Engine.predict at
    ProtT5-XL's width with 8b's 2 of 24 layers, bf16, 3Di under the tie
    rule.  The sharded route's kernel launches are counted from 0 over
    the patched runs and both modes must have launched.  Returns them."""
    import torch

    from unicore_tpu_torch.align.engine import AlignmentEngine, encode_db
    from unicore_tpu_torch.align.prefilter import candidate_pairs
    from unicore_tpu_torch.io.seqdb import SeqDB
    from unicore_tpu_torch.models import prostt5 as P
    from unicore_tpu_torch.ops import nw, nw_device, sw_cuda

    t0 = time.perf_counter()
    dev = ctx["dev"]
    db = SeqDB.read(os.path.join(work, "main", "proteome", "proteome_db"), require_ss=True)
    n = SHARD_SPECIES * PER_SPECIES
    aa, ss = db.aa_seqs[:n], db.ss_seqs[:n]
    q_aa, q_ss = encode_db(aa, ss)
    pairs = candidate_pairs(aa, ss, coverage=0.8, device=dev)
    rng = np.random.RandomState(99)
    S_list = [nw.quantize_scores(rng.randn(a, b) * 2.0 - 1.0 + 6.0 * np.eye(a, b))
              for a, b in rng.randint(1, 700, (NW_MATRICES_9D, 2))]
    seqs = [_random_aa(rng, k) for k in rng.randint(30, 121, CROSS_PROSTT5_SEQS)]
    ckpt = os.path.join(work, "prostt5_cross")  # phase 8b's checkpoint
    home = os.environ["HOME"]
    runs = {}
    try:
        for side in ("single", "sharded"):
            os.environ["HOME"] = os.path.join(work, f"home_9d_{side}")  # a fresh E-value fit
            with local_mesh_is(mesh if side == "sharded" else None):
                if side == "sharded":
                    sw_cuda.reset_launch_counts()
                eng = AlignmentEngine(device=dev)
                hits = eng.align_pairs(q_aa, q_ss, q_aa, q_ss, pairs)
                paths = nw_device.nw_align_batch(S_list, 2816, 256, device=dev)
                p5 = P.ProstT5Engine(ckpt, device=dev)
                codes = p5.predict(seqs)
                if side == "sharded":
                    launches = dict(sw_cuda.SHARDED_LAUNCHES)
                    check(p5._dp[0] == LOGICAL_SHARDS, f"9d: ProstT5 predicted on {p5._dp[0]} shards")
            runs[side] = (hits, eng._stats(), paths, codes, p5)
    finally:
        os.environ["HOME"] = home
    (h1, st1, p1, c1, e1), (h2, st2, p2, c2, _) = runs["single"], runs["sharded"]
    check(launches["gapped"] > 0 and launches["ungapped"] > 0,
          f"9d: the sharded route did not launch both kernel modes: {launches}")
    check([dataclasses.astuple(h) for h in h1] == [dataclasses.astuple(h) for h in h2],
          f"9d: align_pairs sharded != single ({len(h1)} and {len(h2)} hits)")
    check(all(np.array_equal(getattr(st1, k), getattr(st2, k)) for k in ("lengths", "lams", "Ks")),
          "9d: the E-value fit through the sharded branch differs")
    check(p1 == p2, "9d: nw_align_batch sharded != single")
    toks, mask = P.frame_batch(seqs, P._bucket_len(max(map(len, seqs)) + 2))
    lg = P.residue_logits(e1.model, torch.from_numpy(toks).to(dev), torch.from_numpy(mask).to(dev)).float().cpu().numpy()
    n_diff, n_all, widest = check_3di_ties(seqs, c1, c2, lg, "9d: ProstT5 sharded vs single")
    log(f"[phase 9d] engine branches on {LOGICAL_SHARDS} shards of one card equal to one device: align_pairs "
        f"{len(pairs)} pairs of {n} sequences, {len(h2)} hits, the E-value fit equal; nw_align_batch "
        f"{len(S_list)} merges; ProstT5 (2 of 24 layers, bf16) {n_all - n_diff} of {n_all} letters equal "
        f"(widest differing gap {widest:.3g}); sharded launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


def phase_native(ctx, work):
    """Phase 9f: the native featurizer on phase 4's 2,400 sequences,
    bit-identical to its plain version; the better of two timed calls of
    each (the library is already built by phase 4's cluster stage)."""
    from unicore_tpu_torch import native
    from unicore_tpu_torch.align import prefilter
    from unicore_tpu_torch.io.seqdb import SeqDB

    t0 = time.perf_counter()
    native.load()
    load_s = time.perf_counter() - t0
    db = SeqDB.read(os.path.join(work, "main", "proteome", "proteome_db"), require_ss=True)
    times = {}
    for name, fn in (("native", prefilter.featurize), ("plain", prefilter.featurize_plain)):
        best = None
        for _ in range(2):
            t = time.perf_counter()
            feats = fn(db.aa_seqs, db.ss_seqs)
            best = min(best or 1e9, time.perf_counter() - t)
        times[name] = (best, feats)
    check(np.array_equal(times["native"][1], times["plain"][1]), "9f: native featurize != plain")
    log(f"[phase 9f] featurize on {len(db)} sequences ({int(sum(map(len, db.aa_seqs)))} residues), "
        f"bit-identical: native {times['native'][0] * 1e3:.2f} ms, plain {times['plain'][0] * 1e3:.2f} ms "
        f"(host, {os.cpu_count()} cores; library load {load_s * 1e3:.1f} ms)")
    return {k: v[0] for k, v in times.items()}


def phase_multi_device(ctx, work, phylo, dist_ranks):
    """Phase 9: 9a-9c and 9d on a logical mesh of LOGICAL_SHARDS shards of
    the card, 9e's ranks (`dist_ranks`, started before 8b) joined after
    9d, then 9f.
    Returns 9a's numbers with 9d's sharded launches."""
    mesh = logical_mesh(ctx["dev"])
    with span("phase 9a"):
        row = phase_sharded_sw(ctx, mesh)
    with span("phase 9b"):
        phase_sharded_banded_nw(ctx, mesh)
    with span("phase 9c"):
        phase_sharded_phylo(ctx, phylo, mesh)
    with span("phase 9d"):
        row["launches"] = phase_sharded_engines(ctx, work, mesh)
    with span("phase 9e"):
        finish_dist_check(dist_ranks)
    with span("phase 9f"):
        phase_native(ctx, work)
    return row


# ---------------------------------------------------------------------------
# phase 10: ProstT5's training step, tensor and sequence parallelism
# ---------------------------------------------------------------------------

def train_batch(B, L, seed):
    """(tokens, mask, labels): framed random proteins of ragged lengths (the
    first row full), labels uniform over the 20 3Di states."""
    from unicore_tpu_torch.models import prostt5 as P

    rng = np.random.RandomState(seed)
    lengths = [L - 2] + list(rng.randint(L // 4, L - 1, B - 1))
    tokens, mask = P.frame_batch([_random_aa(rng, n) for n in lengths], L, multiple=1)
    return tokens, mask, rng.randint(0, 20, (B, L))


def train_bound(cfg, n_params, B, L):
    """(bound_ms, ops_ms, bytes_ms, flops) of one Adam step on a (B, L)
    batch: 3 x the forward's product and convolution flops (the backward
    twice the forward) over 67 TFLOP/s FP32; the bytes of the step's
    inputs read once and outputs written once (parameters and Adam's two
    moments, 12 B per parameter each way; tokens, mask and labels) over
    3.35 TB/s."""
    D, F, H, dk = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_kv
    ffn = 3 if cfg.ff == "gated-gelu" else 2
    per_layer = 2 * B * L * (4 * D * H * dk + ffn * D * F) + 4 * B * H * L * L * dk
    head = 2 * B * L * cfg.cnn_kernel * (D * cfg.cnn_hidden + cfg.cnn_hidden * cfg.n_classes)
    flops = 3 * (cfg.n_layers * per_layer + head)
    nbytes = 24 * n_params + B * L * (8 + 1 + 8)
    ops_ms, bytes_ms = flops / FP32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms, flops


ABOVE_RELUS = ("head.conv2.weight", "head.conv2.bias")  # no relu between these and the loss


def check_updates(p0, ref, got, g_ref, steps, what):
    """tests/test_torch_train.py's Adam rule on host tensors {name: tensor}:
    updates u = p - p0 of `got` against `ref`, every entry within 2 lr
    steps, entries with |g_ref| >= STRONG max|g_ref| within UPDATE_RTOL
    |u_ref| plus per step one float32 spacing of the parameter and lr
    GRAD_NOISE max|g_ref| / |g_ref|.  Returns the largest share of that
    tolerance taken."""
    worst = 0.0
    for k in p0:
        a0, r, gt, g = (np.asarray(x[k].float().numpy(), np.float64) for x in (p0, ref, got, g_ref))
        u_ref, d = r - a0, np.abs((gt - a0) - (r - a0))
        check(d.max() <= 2 * TRAIN_LR * steps, f"{what}: {k} moved {d.max():.3g} from the reference")
        strong = np.abs(g) >= STRONG * np.abs(g).max()
        spacing = np.spacing(np.maximum(np.abs(a0), np.abs(r)).astype(np.float32))
        turn = TRAIN_LR * GRAD_NOISE * np.abs(g).max() / np.maximum(np.abs(g), 1e-30)
        share = (d / (UPDATE_RTOL * np.abs(u_ref) + steps * (spacing + turn)))[strong].max()
        check(share <= 1, f"{what}: {k}'s Adam update at {share:.3g} of the tolerance")
        worst = max(worst, float(share))
    return worst


def grad_errors(ref, got):
    """{name: (max|got - ref| / max|ref|, |got - ref| / |ref|)}."""
    out = {}
    for k in ref:
        a, b = ref[k].double(), got[k].double()
        out[k] = (float((b - a).abs().max() / a.abs().max()), float((b - a).norm() / a.norm()))
    return out


def check_grads(ref, got, what):
    """Gradients of `got` against `ref`: the tensors no relu stands between
    and the loss (ABOVE_RELUS) within GRAD_RTOL of max|g|, every other
    within RELU_FLIP_L2 of its norm.  Where a relu unit's input is within
    float noise of 0, two float32 sums of it take different derivatives
    (0 or 1) and the gradients below it jump by one token's term: at 24
    layers, tp = 4 against tp = 1 on the CPU (d_model 256), up to 1.1e-2
    of max|g| and 3.1e-3 of the norm, against 2e-6 for the others.
    Returns the largest error of each kind and a line per tensor kept."""
    err = grad_errors(ref, got)
    hi = max(e[0] for k, e in err.items() if k in ABOVE_RELUS)
    below = {k: e for k, e in err.items() if k not in ABOVE_RELUS}
    lines = "; ".join(f"{k} {e[0]:.3g} of max, {e[1]:.3g} of norm" for k, e in err.items()) if len(err) < 10 else ""
    check(hi <= GRAD_RTOL, f"{what}: gradients above the relus at {hi:.3g} of max|g| (limit {GRAD_RTOL}); {lines}")
    lo = max((e[1] for e in below.values()), default=0.0)
    check(lo <= RELU_FLIP_L2, f"{what}: gradients below a relu at {lo:.3g} of their norm (limit {RELU_FLIP_L2}); "
          f"{lines}")
    return hi, lo, max((e[0] for e in below.values()), default=0.0), lines


def timed_steps(model, mesh, cfg, batch, keep):
    """One warm-up Adam step then TRAIN_STEPS timed ones (CUDA events
    around each; the step ends reading the loss) on `model`.  Returns
    (losses, ms per timed step, peak GiB, the warm-up step's gradients of
    `keep` and their parameters after it, on the host)."""
    import torch

    from unicore_tpu_torch.parallel import sharding

    step, init_opt = sharding.make_train_step(cfg, mesh, lr=TRAIN_LR)
    opt = init_opt(model)

    def read(grad):
        if mesh is not None:
            return sharding.gather_state(model, grad=grad, names=keep)
        named = dict(model.named_parameters())
        return {k: (named[k].grad if grad else named[k]).detach().cpu().clone() for k in keep}

    losses, ms = [step(model, opt, *batch)], []
    grads, after = read(True), read(False)
    for _ in range(TRAIN_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        losses.append(step(model, opt, *batch))
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    peak = torch.cuda.max_memory_allocated() / 2**30
    return losses, ms, peak, grads, after


def phase_train(ctx):
    """Phases 10a and 10b: ProstT5's training step at ProtT5-XL's full width
    (T5Config(): 24 layers, 1.2 B float32 parameters, drawn on the card
    from TRAIN_SEED) on a seeded TRAIN_BATCH batch of ragged rows, first
    unsharded (10a), then from the same parameters and batch at tp =
    TRAIN_TP on a logical mesh of the card (10b), each freed before the
    next: a warm-up Adam step and TRAIN_STEPS timed ones at TRAIN_LR.
    Every loss finite and the last below the first.  10b against 10a:
    the warm-up loss within LOSS_RTOL, the warm-up gradients of the
    head, the final RMSNorm and blocks 0 and 23's wo as check_grads
    holds them, and the parameters of the head's second convolution after
    the warm-up step under the Adam rule.  The later losses part (Adam's
    lr sign(g) step turns gradient noise into lr-sized moves, and a deep
    stack amplifies them; JAX's own tp = 4 step parts from its unsharded
    one alike) and are printed.  Prints ms per step, the bound, peak
    memory and tokens per second.  Returns 10a's losses."""
    import torch

    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.models import prostt5 as P
    from unicore_tpu_torch.parallel import sharding
    from unicore_tpu_torch.parallel.mesh import make_mesh

    cfg, dev = P.T5Config(), ctx["dev"]
    B, L = TRAIN_BATCH
    batch = train_batch(B, L, TRAIN_SEED)
    keep = ["head.conv1.weight", "head.conv1.bias", *ABOVE_RELUS, "encoder.final_ln.weight",
            "encoder.blocks.0.wo.weight", f"encoder.blocks.{cfg.n_layers - 1}.wo.weight"]
    runs = {}
    for tp in (1, TRAIN_TP):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = synthetic.prostt5_train_state(cfg, TRAIN_SEED, dev)
        p0 = {k: state[k].cpu().clone() for k in ABOVE_RELUS}
        n_params = sum(v.numel() for v in state.values())
        if tp == 1:
            mesh, model = None, P.build_model(cfg, state, dev, trainable=True)
        else:
            mesh = make_mesh(devices=[dev] * tp, dp=1, tp=tp)
            model = sharding.shard_params(state, mesh)
        del state
        losses, ms, peak, grads, after = timed_steps(model, mesh, cfg, batch, keep)
        del model
        torch.cuda.empty_cache()
        runs[tp] = dict(losses=losses, grads=grads, after=after)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"10: losses at tp = {tp}: {losses}")
        bound, ops_ms, bytes_ms, flops = train_bound(cfg, n_params, B, L)
        step_ms = float(np.median(ms))
        name = "10a" if tp == 1 else "10b"
        log(f"[phase {name}] Adam step at full width ({n_params} float32 parameters, {cfg.n_layers} layers), "
            f"B x L = {B} x {L} ({int(batch[1].sum())} unmasked tokens), tp = {tp}"
            f"{' on a logical mesh of the card' if tp > 1 else ''}: {step_ms:.2f} ms per step, the median of "
            f"{', '.join(f'{m:.2f}' for m in ms)}; bound {bound:.2f} ms ({flops / 1e12:.2f} TFLOP over "
            f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s FP32: {ops_ms:.2f} ms; bytes over 3.35 TB/s: {bytes_ms:.2f} ms), "
            f"{bound / step_ms:.1%} of it; {B * L / step_ms * 1e3:.0f} tokens/s "
            f"({batch[1].sum() / step_ms * 1e3:.0f} unmasked); peak {peak:.2f} GiB; losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; {time.perf_counter() - t0:.1f} s ({ctx['smi']})")
    a, b = runs[1], runs[TRAIN_TP]
    rel = [abs(x / y - 1) for x, y in zip(b["losses"], a["losses"])]
    check(rel[0] <= LOSS_RTOL, f"10b: warm-up loss {rel[0]:.3g} from 10a's (limit {LOSS_RTOL})")
    hi, lo, lo_max, lines = check_grads(a["grads"], b["grads"], "10b")
    share = check_updates(p0, a["after"], b["after"], a["grads"], 1, "10b")
    log(f"[phase 10b] tp = {TRAIN_TP} against 10a: warm-up loss {rel[0]:.3g} apart (limit {LOSS_RTOL}); warm-up "
        f"gradients above the relus at {hi:.3g} of max|g|, below at most {lo:.3g} of their norm ({lo_max:.3g} of "
        f"their max): {lines}; updates of the warm-up step above the relus at {share:.3g} of the Adam rule's "
        f"tolerance; later losses apart by {', '.join(f'{x:.3g}' for x in rel[1:])}")
    return a["losses"]


def phase_train_cross(ctx):
    """Phase 10c: CROSS_TRAIN's layers of 24 at full width, one Adam step at
    (dp, tp) = (2, 2) on a logical mesh of the card against the unsharded
    model on the CPU, from the same parameters and a cut batch: the loss
    within LOSS_RTOL, the gradients as check_grads holds them, the
    head's second convolution under the Adam rule and every parameter
    within 2 lr of the CPU's.  Returns the card's step (10f-i's
    reference): its loss, gradients and parameters after it, and the
    parameters of ABOVE_RELUS before it."""
    import torch

    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.models import prostt5 as P
    from unicore_tpu_torch.parallel import sharding
    from unicore_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n_layers, B, L = CROSS_TRAIN
    cfg = dataclasses.replace(P.T5Config(), n_layers=n_layers)
    batch = train_batch(B, L, TRAIN_SEED + 1)
    state = {k: v.cpu() for k, v in synthetic.prostt5_train_state(cfg, TRAIN_SEED + 1, ctx["dev"]).items()}
    mesh = make_mesh(devices=[ctx["dev"]] * 4, dp=2, tp=2)
    sharded = sharding.shard_params(state, mesh)
    cpu = P.build_model(cfg, {k: v.clone() for k, v in state.items()}, "cpu", trainable=True)
    out = {}
    for name, model, m in (("cuda", sharded, mesh), ("cpu", cpu, None)):
        step, init_opt = sharding.make_train_step(cfg, m, lr=TRAIN_LR)
        loss = step(model, init_opt(model), *batch)
        if m is None:
            named = dict(model.named_parameters())
            grads = {k: p.grad for k, p in named.items()}
            after = {k: p.detach() for k, p in named.items()}
        else:
            grads, after = sharding.gather_state(model, grad=True), sharding.gather_state(model)
        out[name] = (loss, grads, after)
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
    check(abs(l_gpu / l_cpu - 1) <= LOSS_RTOL, f"10c: loss {l_gpu} on the card, {l_cpu} on the CPU")
    hi, lo, lo_max, _ = check_grads(g_cpu, g_gpu, "10c")
    share = check_updates({k: state[k] for k in ABOVE_RELUS}, p_cpu, p_gpu, g_cpu, 1, "10c")
    moved = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    check(moved <= 2 * TRAIN_LR, f"10c: a parameter {moved:.3g} from the CPU's after one step")
    del sharded
    torch.cuda.empty_cache()
    log(f"[phase 10c] {n_layers} of 24 layers at full width, B x L = {B} x {L}, (dp, tp) = (2, 2) on the card "
        f"against the CPU: loss {l_gpu:.6f} and {l_cpu:.6f} ({abs(l_gpu / l_cpu - 1):.3g} apart); gradients above "
        f"the relus at {hi:.3g} of max|g|, the {len(g_cpu) - len(ABOVE_RELUS)} below at most {lo:.3g} of their norm "
        f"({lo_max:.3g} of their max); Adam updates above the relus at {share:.3g} of the tolerance, every "
        f"parameter within {moved:.3g} of the CPU's; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(loss=l_gpu, grads=g_gpu, after=p_gpu, p0={k: state[k] for k in ABOVE_RELUS})


def phase_tp_predict(ctx, work):
    """Phase 10e: make_sharded_predict at tp = TRAIN_TP on a logical mesh of
    the card, 8b's bf16 checkpoint (2 of 24 layers at full width), on
    8b's kind of sequences: 3Di against the unsharded model's under the
    tie rule."""
    import torch

    from unicore_tpu_torch.alphabets import TDI_ALPHABET
    from unicore_tpu_torch.models import prostt5 as P
    from unicore_tpu_torch.parallel import sharding
    from unicore_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    ckpt = os.path.join(work, "prostt5_cross")  # phase 8b's checkpoint
    cfg = P.infer_config(ckpt)
    model = P.build_model(cfg, P.load_params(ckpt, cfg, dtype=torch.bfloat16), ctx["dev"])
    rng = np.random.RandomState(12)
    seqs = [_random_aa(rng, n) for n in rng.randint(30, 121, CROSS_PROSTT5_SEQS)]
    toks, mask = P.frame_batch(seqs, P._bucket_len(max(map(len, seqs)) + 2))
    tg, mg = torch.from_numpy(toks).to(ctx["dev"]), torch.from_numpy(mask).to(ctx["dev"])
    lg = P.residue_logits(model, tg, mg).float().cpu().numpy()
    run = sharding.make_sharded_predict(cfg, model, make_mesh(devices=[ctx["dev"]] * TRAIN_TP, dp=1, tp=TRAIN_TP))
    got = run(toks, mask)
    tdi = np.frombuffer(TDI_ALPHABET.encode(), np.uint8)

    def strings(codes):
        return [tdi[codes[r, 1:len(s) + 1]].tobytes().decode() for r, s in enumerate(seqs)]

    n_diff, n_all, widest = check_3di_ties(seqs, strings(lg.argmax(-1)), strings(got), lg,
                                           f"10e: tp = {TRAIN_TP} predict vs one device")
    del model, run
    torch.cuda.empty_cache()
    log(f"[phase 10e] make_sharded_predict at tp = {TRAIN_TP} (bf16, 2 of 24 layers at full width) against one "
        f"device: {n_all - n_diff} of {n_all} letters equal (widest differing gap {widest:.3g}); "
        f"{time.perf_counter() - t0:.1f} s")


def write_batch(path, tokens, mask, labels):
    np.savez(path, tokens=tokens, mask=mask, labels=labels)
    return path


def start_rank_cross(work):
    """Phase 10f-i, start: RANK_MESH's dp x tp gloo ranks of dist_check's
    training mode on this card, one Adam step of 10c's layers at full
    width from 10c's seed on 10c's batch, rank 0 writing the gathered
    loss, gradients and parameters."""
    n_layers, B, L = CROSS_TRAIN
    dp, tp = RANK_MESH
    batch = write_batch(os.path.join(work, "rank_cross_batch.npz"), *train_batch(B, L, TRAIN_SEED + 1))
    out = os.path.join(work, "rank_cross_out.npz")
    args = ["--train", f"{dp}x{tp}", "--width", "full", "--layers", n_layers, "--steps", 1, "--lr", TRAIN_LR,
            "--seed", TRAIN_SEED + 1, "--batch", batch, "--out", out]
    return start_ranks(dp * tp, args, "10f-i"), out


def finish_rank_cross(started, ref):
    """Phase 10f-i, end: the ranks' step against 10c's one-process step at
    the same (dp, tp) on a logical mesh of the card (`ref`), to 10c's
    tolerances: the loss within LOSS_RTOL, the gradients as check_grads
    holds them, the head's second convolution under the Adam rule and
    every parameter within 2 lr.  Each rank checked that its replicated
    leaves are bit-identical to every other rank's."""
    import torch

    (procs, t0), out = started
    lines = finish_ranks((procs, t0), "10f-i")
    with np.load(out) as z:
        loss = float(z["loss"][0])
        grads = {k[5:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("grad/")}
        after = {k[6:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("param/")}
        coords = z["coords"].tolist()
    dp, tp = RANK_MESH
    check(coords == [list(divmod(r, tp)) for r in range(dp * tp)], f"10f-i: ranks placed at {coords}")
    rel = abs(loss / ref["loss"] - 1)
    check(rel <= LOSS_RTOL, f"10f-i: loss {loss} over the ranks, {ref['loss']} in one process")
    hi, lo, lo_max, _ = check_grads(ref["grads"], grads, "10f-i")
    share = check_updates(ref["p0"], ref["after"], after, ref["grads"], 1, "10f-i")
    moved = max(float((after[k] - ref["after"][k]).abs().max()) for k in ref["after"])
    check(moved <= 2 * TRAIN_LR, f"10f-i: a parameter {moved:.3g} from the one-process step's")
    log(f"[phase 10f-i] {dp * tp} gloo ranks at (dp, tp) = ({dp}, {tp}) on this card, {CROSS_TRAIN[0]} of 24 "
        f"layers at full width, one Adam step against 10c's one-process step on a logical mesh: loss {loss:.6f} "
        f"({rel:.3g} apart); gradients above the relus at {hi:.3g} of max|g|, below at most {lo:.3g} of their "
        f"norm ({lo_max:.3g} of their max); updates above the relus at {share:.3g} of the Adam rule's "
        f"tolerance, every parameter within {moved:.3g}; replicated leaves bit-identical on every rank; "
        f"{time.perf_counter() - t0:.1f} s from the ranks' start")
    for line in lines:
        log(f"  {line}")


def rank_numbers(line):
    """{key: value} of a dist_check "OK ..." line's key=value fields."""
    return dict(f.split("=", 1) for f in line.split() if "=" in f)


def start_rank_tp(work):
    """Phase 10f-ii, start: ProtT5-XL's full width (24 layers) over RANK_TP
    gloo ranks of this card at (dp, tp) = (1, RANK_TP), each drawing 10a's
    state from TRAIN_SEED and keeping its slices, RANK_STEPS Adam steps
    on 10a's batch."""
    B, L = TRAIN_BATCH
    batch = write_batch(os.path.join(work, "rank_tp_batch.npz"), *train_batch(B, L, TRAIN_SEED))
    args = ["--train", f"1x{RANK_TP}", "--width", "full", "--layers", 24, "--steps", RANK_STEPS,
            "--lr", TRAIN_LR, "--seed", TRAIN_SEED, "--batch", batch]
    return start_ranks(RANK_TP, args, "10f-ii")


def finish_rank_tp(ctx, started, losses_10a):
    """Phase 10f-ii, end: the first loss within LOSS_RTOL of 10a's, every
    loss finite, the last below the first.  Prints each rank's ms per
    step after the first and its peak memory: RANK_TP processes sharing
    one card, their collectives through host copies over gloo, not the
    speed of several cards."""
    lines = finish_ranks(started, "10f-ii", timeout=600)
    nums = [rank_numbers(line) for line in lines]
    losses = [float(x) for x in nums[0]["loss"].split(",")]
    check(all(n["loss"] == nums[0]["loss"] for n in nums), f"10f-ii: the ranks' losses differ: {lines}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"10f-ii: losses {losses}")
    rel = abs(losses[0] / losses_10a[0] - 1)
    check(rel <= LOSS_RTOL, f"10f-ii: first loss {losses[0]} over the ranks, {losses_10a[0]} in 10a")
    per_rank = "; ".join(
        f"rank {r}: {np.mean([float(x) for x in n['ms'].split(',')[1:]]):.1f} ms per step after the first "
        f"({n['ms']}), peak {float(n['peak_gib']):.2f} GiB" for r, n in enumerate(nums))
    log(f"[phase 10f-ii] {RANK_TP} gloo ranks at (dp, tp) = (1, {RANK_TP}) sharing this card, 24 layers at full "
        f"width from 10a's parameters and batch: losses {', '.join(f'{x:.6f}' for x in losses)}, the first "
        f"{rel:.3g} from 10a's {losses_10a[0]:.6f} (limit {LOSS_RTOL}); {per_rank} (two processes on one card, "
        f"collectives through host copies; {ctx['smi']}); {time.perf_counter() - started[1]:.1f} s from the "
        f"ranks' start")


def phase_training(ctx, work, cross_ranks):
    """Phase 10: 10a and 10b (phase_train), 10c, the port's dry run
    `graft_entry.dryrun_multichip(4)` on a logical mesh of the card (10d),
    then 10e, one after another, 10f-i (`cross_ranks`, started before 8b,
    against 10c), then 10f-ii (its ranks started after 10b, beside
    10c-10f-i)."""
    from unicore_tpu_torch import graft_entry

    with span("phase 10a, 10b"):
        losses_10a = phase_train(ctx)
    rank_tp = start_rank_tp(work)
    with span("phase 10c"):
        ref = phase_train_cross(ctx)
    with span("phase 10d"):
        out = graft_entry.dryrun_multichip(LOGICAL_SHARDS, devices=[ctx["dev"]] * LOGICAL_SHARDS)
        log(f"[phase 10d] graft_entry.dryrun_multichip({LOGICAL_SHARDS}) on a logical mesh of the card: "
            f"dp = {out['dp']}, tp = {out['tp']}, loss {out['loss']:.6f}")
    with span("phase 10e"):
        phase_tp_predict(ctx, work)
    with span("phase 10f-i"):
        finish_rank_cross(cross_ranks, ref)
    with span("phase 10f-ii"):
        finish_rank_tp(ctx, rank_tp, losses_10a)


def phase6_op_times(ctx, msa_files):
    """The slice's new PyTorch device work timed alone (phase 6c's end):
    one canopy gram at the size of 6a's first chunk (2,048 bags of 2,048
    bits, a quarter set, copies to and from the card included), and one
    `_loglik_multi_impl` call over 6c's lockstep group (each gene's NNI
    candidates of its NJ tree, JTT+F+G) against the per-gene
    `loglik_batch` calls it replaces."""
    from unicore_tpu_torch.align.cascade import _gram
    from unicore_tpu_torch.io.fasta import read_fasta
    from unicore_tpu_torch.phylo import genebatch
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import models as tm
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.phylo.nj import neighbor_joining, protein_distances

    bags = (np.random.RandomState(6).rand(2048, 2048) < 0.25).astype(np.float32)
    gram_ms = time_cuda(lambda: _gram(bags, bags, ctx["dev"]), 5)
    engines, cbs, bbs = [], [], []
    msas = [read_fasta(m) for m in msa_files]
    bucket = max(gene_key(m)[1] for m in msa_files)
    for msa in msas:
        names, seqs = list(msa), list(msa.values())
        model = tm.SubstModel.build(tm.ModelSpec.parse("JTT+F+G"), alpha=1.0,
                                    empirical_freqs=tl.empirical_frequencies(tl.msa_to_codes(names, seqs)))
        engines.append(tl.LikelihoodEngine(names, seqs, model, pad_patterns_to=bucket))
        root = neighbor_joining(protein_distances(names, seqs), names)
        arr = [tl.tree_to_arrays(c, names) for c in ts.nni_neighbors(tl.make_root_binary(root))]
        cbs.append(np.stack([a[0] for a in arr]))
        bbs.append(np.maximum(np.stack([a[1] for a in arr]), 1e-3))
    K = max(len(c) for c in cbs)
    cb, bb = (np.stack([np.concatenate([x, np.repeat(x[:1], K - len(x), 0)]) for x in xs]) for xs in (cbs, bbs))
    multi_ms = time_cuda(lambda: genebatch.loglik_multi(engines, cb, bb), 5)
    solo_ms = time_cuda(lambda: [e.loglik_batch(c, b) for e, c, b in zip(engines, cb, bb)], 5)
    log(f"  canopy gram of 2048 x 2048 bags (copies included): {gram_ms:.3f} ms; _loglik_multi_impl over "
        f"{len(engines)} genes x {K} candidates at {engines[0].n} taxa x {bucket} patterns: {multi_ms:.2f} ms, "
        f"the per-gene loglik_batch calls it replaces {solo_ms:.2f} ms ({ctx['smi']})")
    return dict(gram_ms=gram_ms, multi_ms=multi_ms, solo_ms=solo_ms)


def split_cores():
    """(foreground, background) CPU sets: two cores for the checks that
    drive the card, the others for phase 5's CPU run beside them.  With
    fewer than 4 cores both get every core: the run is slower, and still
    no timed phase has anything beside it."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return set(cores), set(cores)
    return set(cores[:2]), set(cores[2:])


def _on_cores(cores, fn, *args):
    """fn(*args) with the calling thread, and every process it starts,
    pinned to `cores` (Linux affinity is per thread and inherited)."""
    os.sched_setaffinity(0, cores)
    return fn(*args)


def start_crosscheck(work, pool, cores):
    """Phase 5, first half: write its proteomes (and 6b's) and start its
    CPU run in `pool` on `cores`, with one torch thread per core, 6b's CPU
    run beside its easy-core, 7c's after its raxml-ng tree, 6d's and 7b's
    after its other trees; returns (input directory, the run's future)."""
    from unicore_tpu_torch import synthetic

    small = os.path.join(work, "small")
    synthetic.write_proteomes(small, CROSS_SPECIES, CROSS_PER_SPECIES, seed=11, long_family=True)
    synthetic.write_proteomes(os.path.join(work, "casc_in"), CROSS_SPECIES, CROSS_CASCADE_PER_SPECIES, seed=11)
    x_cpu = os.path.join(work, "x_cpu")
    return small, pool.submit(_on_cores, cores, _ended, run_easy_core, small, x_cpu, os.path.join(work, "home_cpu"),
                              "cpu", len(cores), cascade_steps(work, "cpu"),
                              lambda trees: cross_sides(work, x_cpu, "cpu", trees))


def _ended(fn, *args):
    """(fn(*args), the script's clock when it returned)."""
    out = fn(*args)
    return out, clock()


def phase_crosscheck(ctx, work, small, cpu_run, t0):
    """Phase 5: easy-core, the two other aligners and the two other tree
    builders on CUDA (here) and on the CPU (`cpu_run`, started at t0): the
    same files, byte-identical up to inference, the inference outputs
    within the stated tolerances.  Then phases 6b, 6d, 7b and 7c (their
    CUDA runs: 6b beside easy-core, 7c, 6d and 7b after it, as on the
    CPU)."""
    x_cuda = os.path.join(work, "x_cuda")
    with span("phase 5, CUDA run (with 6b, 7c, 6d and 7b)"):
        cuda_times, cuda_counters = run_easy_core(small, x_cuda, os.path.join(work, "home_cuda"), None, None,
                                                  cascade_steps(work, "cuda"),
                                                  lambda trees: cross_sides(work, x_cuda, "cuda", trees))
    fg_done = clock()
    with span("wait: phase 5's CPU run"):
        (cpu_times, cpu_counters), cpu_end = cpu_run.result()
    log(f"[phase 5] the card's cores ended their work at {fg_done:.1f} s; the CPU run ended at {cpu_end:.1f} s "
        f"({ctx['smi']})")
    record_span("phase 5, CPU run (with 6b, 6d, 7b and 7c)", t0 - _CLOCK[0], cpu_end, lane="cpu")
    a, b = read_files(os.path.join(work, "x_cpu")), read_files(os.path.join(work, "x_cuda"))
    n_inf = check_same_files(a, b)
    for want in ("cluster/clust.tsv", "tree/combined.fasta", "tree/iqtree.treefile", "tree_mafft/combined.fasta",
                 "tree_linsi/combined.fasta.partitions", "tree_fasttree/fasttree.nwk",
                 "tree_raxml/raxml-ng.raxml.support"):
        check(want in a, f"cross-check wrote no {want}")
    check(a["tree/tree.chk"] == b"1", "easy-core's tree.chk does not read 1")
    check(any(n.startswith("profile/") and n.endswith(".txt") for n in a), "cross-check found no core genes")
    check(sum(int(cpu_counters["easy-core"].get(f"kernel.{n}.{k}.launches", 0))
              for n in ("sw", "banded") for k in ("gapped", "ungapped")) == 0
          and sum(dirbits_launches(cpu_counters).values()) == 0, "the CPU run launched a kernel")
    banded = kernel_launches(cuda_counters["easy-core"])
    check(banded["banded.gapped"] > 0 and banded["banded.ungapped"] > 0,
          f"phase 5's long family did not go through the banded kernel on CUDA: {banded}")
    nw = dirbits_launches({"easy-core": cuda_counters["easy-core"]})["nw"]
    check(nw == int(cuda_counters["easy-core"]["msa.dispatches"]) > 0,
          f"phase 5: {int(cuda_counters['easy-core']['msa.dispatches'])} NW forward dispatches on CUDA, {nw} "
          f"direction-bit kernel launches")
    log(f"[phase 5] CUDA and CPU runs of easy-core, tree -n (mafft, mafft-linsi) and tree -T fasttree|raxml-ng "
        f"at {CROSS_SPECIES} x {CROSS_PER_SPECIES}: {len(a)} files, {len(a) - n_inf} byte-identical, "
        f"{n_inf} inference outputs within tolerance; {time.perf_counter() - t0:.1f} s since the CPU run "
        f"started beside phases 1-3c")
    log("  step                 CUDA s    CPU s")
    for k in cuda_times:
        kc = k.replace("cuda", "cpu")
        log(f"  {k:22s} {cuda_times[k]:7.2f} {cpu_times[kc]:8.2f}")
    phase_cross6(ctx, work, (cuda_times, cuda_counters), cpu_times, cpu_counters)
    phase_cross7(ctx, work, (cuda_times, cuda_counters), cpu_times, cpu_counters)


def checks_beside_cpu_run(work):
    """Phase 1 and the checks of phases 2, 2b, 3c and 3d on two cores,
    while phase 5's CPU run (a cross-check, timed by nothing) and 6e's
    `config --check` go on on the others from the start; then, the CPU
    run near its end, 6a, the checks of 2c and 3b, 6e's reading and 2d
    (in a thread of their own) beside phase 5's CUDA run (with 6b, 6d, 7b
    and 7c) on every core, and the int16 probe on the CPU run's cores
    from 6a on.  Returns the context, phases 2-2d's
    errors and the inputs of the timed phases (the probe's numbers among
    them)."""
    fg, bg = split_cores()
    every_core = os.sched_getaffinity(0)
    probe = None
    with ThreadPoolExecutor(1) as pool:
        t5 = time.perf_counter()
        small, cpu_run = start_crosscheck(work, pool, bg)
        config = start_config(work, bg)
        os.sched_setaffinity(0, fg)
        try:
            with span("phase 1"):
                ctx = phase_env()
            inputs = {}
            log(f"[phase 5] CPU run and 6e started on cores {sorted(bg)}; phases 1-3d's checks run on cores "
                f"{sorted(fg)}")
            with span("phase 2"):
                max_err = phase_exact(ctx)
            with span("phase 2b"):
                max_err.update({f"banded.{k}": v for k, v in phase_banded_exact(ctx).items()})
            with span("phase 3c, checks"):
                inputs["phylo"] = phase_phylo(ctx)
            with span("phase 3d, checks"):
                inputs["sw_bits"] = phase_sw_bits(ctx)
            # the CPU run is near its end: phase 5's CUDA run and its sides take every core
            os.sched_setaffinity(0, every_core)
            # 6a in process in a thread of its own with 2c's and 3b's checks,
            # 6e and 2d, beside phase 5's CUDA run (subprocesses): the card is
            # mostly waiting on launches, and the window is set by the slower
            # side; the int16 probe on the cores of phase 5's CPU run
            probe = start_probe(work, bg)
            with ThreadPoolExecutor(1) as side:
                beside = side.submit(phase_side, ctx, work, config)
                phase_crosscheck(ctx, work, small, cpu_run, t5)
                with span("wait: 6a, 2c, 3b, 6e, 2d"):
                    side_err, inputs["nw"] = beside.result()
                    max_err.update(side_err)
            with span("int16 probe"):
                inputs["probe"] = finish_probe(probe)
        except BaseException:
            stop_cli_runs()  # or the pool would wait for the CPU run
            if probe is not None and probe[0].poll() is None:
                probe[0].kill()
            raise
        finally:
            os.sched_setaffinity(0, every_core)
    return ctx, max_err, inputs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    _CLOCK[0] = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    # in-process phases (6a's E-value fit) keep their caches under `work`
    os.environ["HOME"] = os.path.join(work, "home_inproc")
    try:
        ctx, max_err, inputs = checks_beside_cpu_run(work)
        # from here on nothing runs beside the timed phases
        log(f"[{clock():.1f} s] phases 3 and 3b-3g, timed ({ctx['smi']})")
        with span("phase 3, times"):
            timing = phase_times(ctx)
        with span("phase 3b, times"):
            nw_timing = phase_nw_times(ctx, inputs["nw"])
        with span("phase 3c, times"):
            phase_phylo_times(ctx, inputs["phylo"])
        with span("phase 3d, times"):
            swb_timing = phase_sw_bits_times(ctx, inputs["sw_bits"])
        with span("phase 3e, times"):
            banded_timing = phase_banded_times(ctx)
        with span("phase 3f, times"):
            phase_dirbits_sweep(ctx)
        with span("phase 3g, times"):
            i16_timing = phase_i16_times(ctx)
        with span("phase 4"):
            launches, inference = phase_slice(work)
        with span("phase 7a"):
            search_launches = phase_search(ctx, work)
        with span("phase 3f, main-path shapes"):
            phase_dirbits_shape_times(ctx, merge_shapes(launches["dirbits_shapes"], search_launches["dirbits_shapes"]))
        with span("phase 7d"):
            phase_partition(ctx, work, inference)
        with span("phase 6c"):
            phase_genetree(ctx, work)
        with span("phase 8a"):
            phase_prostt5(ctx, work)
        # 9e's and 10f-i's ranks start up beside 8b and phase 9 (10f-i's beside 10a-10e too)
        dist_ranks, cross_ranks = start_dist_check(), start_rank_cross(work)
        with span("phase 8b"):
            phase_prostt5_cross(ctx, work)
        with span("phase 9"):
            sharded = phase_multi_device(ctx, work, inputs["phylo"], dist_ranks)
        with span("phase 10"):
            phase_training(ctx, work, cross_ranks)
    finally:
        stop_cli_runs()
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for kind in ("gapped", "ungapped"):
        t = timing[(*KERNEL_SHAPE, kind)]
        kernels.append({
            "name": f"sw_forward_{kind}", "route": "cuda",
            "source": "unicore_tpu_torch/csrc/sw.cu",
            "replaces": "unicore_tpu/ops/sw.py:183",
            "launches": launches[kind] + search_launches[kind], "max_abs_err": max_err[kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for kind in ("gapped", "ungapped"):
        t = banded_timing[kind]
        kernels.append({
            "name": f"sw_forward_banded_{kind}", "route": "cuda",
            "source": "unicore_tpu_torch/csrc/banded.cu",
            "replaces": "unicore_tpu/ops/banded.py:210",
            "launches": launches[f"banded.{kind}"] + search_launches[f"banded.{kind}"],
            "max_abs_err": max_err[f"banded.{kind}"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for kind, name, replaces, t in (
            ("nw", "nw_forward_bits", "unicore_tpu/ops/nw_device.py:40", nw_timing[(*NW_TIMED[0], "int32")]),
            ("sw_bits", "sw_forward_bits", "unicore_tpu/ops/sw_bits.py:40", swb_timing[(*SWB_TIMED[0], "int16")])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "unicore_tpu_torch/csrc/dirbits.cu",
            "replaces": replaces,
            "launches": launches[kind] + search_launches[kind], "max_abs_err": max_err[kind],
            "ms": t["kernel_ms"], "plain_ms": t["ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for kind in ("gapped", "ungapped"):
        t = i16_timing[(*I16_TIMED, kind)]
        kernels.append({
            "name": f"sw_forward_i16_packed_{kind}", "route": "cuda",
            "source": "unicore_tpu_torch/csrc/sw.cu",
            "replaces": "unicore_tpu/ops/sw.py:361",
            "launches": launches[f"{kind}_i16"] + search_launches[f"{kind}_i16"],
            "max_abs_err": max_err[f"{kind}_i16"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    probe = inputs["probe"]
    kernels.append({
        "name": "probe_i16", "route": "cuda",
        "source": "unicore_tpu_torch/csrc/probe_i16.cu",
        "replaces": "scripts/probe_i16.py:44",
        "launches": 0, "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })
    kernels.append({
        "name": "sw_forward_sharded", "route": "cuda",
        "source": "unicore_tpu_torch/csrc/sw.cu",
        "replaces": "unicore_tpu/ops/sw.py:718",
        "launches": sum(sharded["launches"].values()), "max_abs_err": sharded["max_abs_err"],
        "ms": sharded["ms"], "plain_ms": sharded["plain_ms"], "bound_ms": sharded["bound_ms"],
        "bound_by": sharded["bound_by"], "library_ms": None,
    })
    critical_path()
    log(f"total {clock():.1f} s ({ctx['smi']})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
