"""Synthetic proteomes with known gene families, for smoke runs and profiling.

`write_proteomes` evolves gene families along a random species tree with
substitutions and indels, drops some families from some species and
duplicates others (so core and non-core genes both occur), fills every
proteome up to a fixed size with species-specific orphan genes, and
writes one FASTA per species.  Lengths follow a bacterial-like lognormal
(median 300, clipped to 50-2,000), so a few percent take the banded path.
Everything comes from one numpy seed, and `species_tree` rebuilds the
species tree of a seed (the reference of an inferred tree).
`cluster_purity` scores a `cluster` run against the generating families;
`simulate_msa` makes an aligned MSA along a random tree (likelihood
inputs).  `sw_edge_pairs` makes
Smith-Waterman inputs at the edges of the kernel's mapping, `nw_scores`
score batches for the NW forward (ops/nw_device.py).
`prostt5_hf_tensors` and `write_prostt5_json` make a ProstT5 checkpoint
in the real HF layout from random weights (models/prostt5.py loads it);
`prostt5_train_state` draws a float32 state to train on a device.
"""

from __future__ import annotations

import math
import os

import numpy as np

LETTERS = "ARNDCQEGHILKMFPSTWYV"


def random_tree(rng, species, depth):
    """Random rooted binary tree as a list of (parent, child, length);
    node ids 0..n-1 are the leaves, the last id is the root."""
    nodes = list(range(len(species)))
    edges, nxt = [], len(species)
    while len(nodes) > 1:
        a, b = rng.choice(len(nodes), 2, replace=False)
        na, nb = nodes[a], nodes[b]
        for ch in (na, nb):
            edges.append((nxt, ch, float(rng.uniform(0.3, 1.0))))
        nodes = [n for i, n in enumerate(nodes) if i not in (a, b)] + [nxt]
        nxt += 1
    # scale so the mean root-to-leaf path is `depth` substitutions per site
    parent = {c: (p, l) for p, c, l in edges}

    def path(n):
        s = 0.0
        while n in parent:
            p, l = parent[n]
            s, n = s + l, p
        return s

    scale = depth / np.mean([path(i) for i in range(len(species))])
    return [(p, c, l * scale) for p, c, l in edges], nxt - 1


def mutate(rng, seq, dist):
    """Copy of `seq` after `dist` substitutions per site (uniform over the
    20 letters) and about dist * 0.05 indels per site."""
    seq = seq.copy()
    n_sub = rng.poisson(dist * len(seq))
    pos = rng.randint(0, len(seq), n_sub)
    seq[pos] = rng.randint(0, 20, n_sub)
    for _ in range(rng.poisson(dist * 0.05 * len(seq))):  # indels, mean length 3
        k = rng.geometric(0.4)
        cut = rng.randint(1, max(2, len(seq) - 1))
        if rng.rand() < 0.5 and len(seq) > 60:
            seq = np.delete(seq, slice(cut, cut + k))
        else:
            seq = np.insert(seq, cut, rng.randint(0, 20, k))
    return seq


def _species(n_species):
    return [f"sp{i:02d}" for i in range(n_species)]


def species_tree(n_species, seed):
    """The species tree `write_proteomes(..., n_species, ..., seed)`
    evolves its families along (its RandomState's first draw), as a
    rooted phylo.newick.Node whose leaves are the species names and whose
    branch lengths are substitutions per site."""
    from unicore_tpu_torch.phylo.newick import Node

    species = _species(n_species)
    edges, root = random_tree(np.random.RandomState(seed), species, depth=0.25)
    nodes = {i: Node(name) for i, name in enumerate(species)}
    for p, c, length in edges:  # children come before their parents
        nodes[c].length = length
        nodes.setdefault(p, Node()).add(nodes[c])
    return nodes[root]


def write_proteomes(out_dir, n_species, per_species, seed, long_family=False):
    """Write `n_species` FASTAs of `per_species` proteins into `out_dir`;
    returns {header: family id} (orphans get unique negative ids).
    `long_family` makes the first family 1,100 residues long."""
    rng = np.random.RandomState(seed)
    species = _species(n_species)
    edges, root = random_tree(rng, species, depth=0.25)
    children = {}
    for p, c, l in edges:
        children.setdefault(p, []).append((c, l))
    n_fam = int(per_species * 0.85)
    genomes = {sp: [] for sp in species}
    for f in range(n_fam):
        L = int(np.clip(np.exp(rng.normal(math.log(300), 0.65)), 50, 2000))
        if long_family and f == 0:
            L = 1100
        root_seq = rng.randint(0, 20, L)
        leaves = {}
        stack = [(root, root_seq)]
        while stack:
            node, seq = stack.pop()
            if node < n_species:
                leaves[node] = seq
            for c, l in children.get(node, []):
                stack.append((c, mutate(rng, seq, l)))
        missing = set()
        if rng.rand() < 0.3:
            missing = set(rng.choice(n_species, rng.randint(1, 4), replace=False).tolist())
        for i, sp in enumerate(species):
            if i in missing:
                continue
            genomes[sp].append((f"{sp}_f{f:04d}_c0", f, leaves[i]))
        if rng.rand() < 0.1:  # a paralog in one species
            i = int(rng.randint(n_species))
            if i not in missing:
                genomes[species[i]].append(
                    (f"{species[i]}_f{f:04d}_c1", f, mutate(rng, leaves[i], 0.1)))
    labels = {}
    os.makedirs(out_dir, exist_ok=True)
    orphan = 0
    for sp in species:
        recs = genomes[sp][:per_species]
        while len(recs) < per_species:  # species-specific orphan genes
            L = int(np.clip(np.exp(rng.normal(math.log(300), 0.65)), 50, 2000))
            recs.append((f"{sp}_orphan{orphan:04d}", -1 - orphan, rng.randint(0, 20, L)))
            orphan += 1
        order = rng.permutation(len(recs))
        with open(os.path.join(out_dir, f"{sp}.fasta"), "w") as fh:
            for k in order:
                name, fam, seq = recs[k]
                labels[name] = fam
                fh.write(f">{name}\n{''.join(LETTERS[c] for c in seq)}\n")
    return labels


def simulate_msa(rng, n_taxa, L, sub_rate=0.12, gap_frac=1 / 30):
    """{name: aligned AA row} evolved along a random binary tree: each
    edge substitutes about sub_rate * L random positions, and each leaf
    gets about gap_frac * L gap columns.  Names t0..t{n-1}, sorted."""
    items = [("leaf", i) for i in range(n_taxa)]
    while len(items) > 1:
        a, b = rng.choice(len(items), 2, replace=False)
        items = [it for k, it in enumerate(items) if k not in (a, b)] + \
            [("int", (items[a], items[b]))]
    rows = {}
    stack = [(items[0], rng.randint(0, 20, L))]
    while stack:
        (kind, v), seq = stack.pop()
        if kind == "leaf":
            row = np.array(list(LETTERS))[seq]
            row[rng.randint(0, L, int(L * gap_frac))] = "-"
            rows[f"t{v}"] = "".join(row)
            continue
        for ch in v:
            s = seq.copy()
            k = rng.poisson(sub_rate * L)
            s[rng.randint(0, L, k)] = rng.randint(0, 20, k)
            stack.append((ch, s))
    return {k: rows[k] for k in sorted(rows, key=lambda s: int(s[1:]))}


def cluster_purity(out_dir, labels):
    """Share of clustered sequences whose cluster's majority family is
    their own (sequence names map to headers through the .map file)."""
    header = {}
    for line in open(os.path.join(out_dir, "proteome", "proteome_db.map")):
        name, _, hdr = line.rstrip("\n").split("\t")
        header.setdefault(name, hdr)
    clusters = {}
    for line in open(os.path.join(out_dir, "cluster", "clust.tsv")):
        rep, mem = line.split()
        clusters.setdefault(rep, []).append(labels[header[mem]])
    total = sum(len(m) for m in clusters.values())
    pure = sum(max(np.unique(m, return_counts=True)[1]) for m in clusters.values())
    return pure / total, len(clusters)


SW_EDGE_CASES = ("ragged", "full", "len1", "ties", "gap_bonus", "big_bias")


def sw_edge_pairs(rng, case, B, Lq, Lt):
    """SW inputs at the edges of the kernel's mapping; returns
    ((qa, qs, ta, ts, qlen, tlen, qc), go, ge).  Any Lq, Lt >= 1.

    ragged     lengths anywhere in [1, L]; every other pair's query copies
               a window of its target with substitutions and a deletion
    full       every row and column in use (no padding)
    len1       qlen or tlen of 1
    ties       one repeated code per pair: many cells hold the best score
    gap_bonus  a negative gap open: E and F raise scores, so the best cell
               can lie in a column >= tlen or a row >= qlen
    big_bias   |qc| above 2**24, where the bias add must stay in float64
    """
    qa = rng.randint(0, 20, (B, Lq)).astype(np.int32)
    qs = rng.randint(0, 20, (B, Lq)).astype(np.int32)
    ta = rng.randint(0, 20, (B, Lt)).astype(np.int32)
    ts = rng.randint(0, 20, (B, Lt)).astype(np.int32)
    ql = rng.randint(1, Lq + 1, B).astype(np.int32)
    tl = rng.randint(1, Lt + 1, B).astype(np.int32)
    if case == "full":
        ql[:], tl[:] = Lq, Lt
    for b in range(0, B, 2):
        w = int(min(ql[b], tl[b]))
        src_a, src_s = ta[b, :w].copy(), ts[b, :w].copy()
        if w > 8:
            cut = w // 2
            src_a = np.concatenate([src_a[:cut], src_a[cut + 2:]])
            src_s = np.concatenate([src_s[:cut], src_s[cut + 2:]])
        sub = rng.randint(0, len(src_a), max(1, len(src_a) // 8))
        src_a[sub] = rng.randint(0, 20, len(sub))
        qa[b, :len(src_a)] = src_a
        qs[b, :len(src_s)] = src_s
    qc = rng.randint(-60, 40, (B, Lq)).astype(np.int32)
    go, ge = 100.0, 10.0
    if case == "len1":
        ql[0::2] = 1
        tl[0::3] = 1
    elif case == "ties":
        for b in range(B):
            code = rng.randint(0, 20)
            qa[b], qs[b], ta[b], ts[b] = code, code, code, code
        qc[:] = 0
    elif case == "gap_bonus":
        go, ge = -10.0, 2.0
    elif case == "big_bias":
        qc = rng.choice([-(1 << 25) - 3, (1 << 24) + 1, 5, -7], size=(B, Lq)).astype(np.int32)
    return (qa, qs, ta, ts, ql, tl, qc), go, ge


NW_SCORE_KINDS = ("rand", "zero", "const")
PAD_SCORE = -20000  # == ops/nw_device.PAD_SCORE


def nw_scores(rng, B, L1, L2, kind="rand"):
    """(S (B, L1, L2) int16, l1 (B,) int32, l2 (B,) int32) for
    ops/nw_device.nw_forward_bits.

    rand   quantized-profile-score-like values with a planted diagonal
    zero   every cell 0: every choice of the DP is a tie
    const  every cell -3

    Lengths are ragged down to 1 (the first pair has one row, the last one
    column, the middle one is full); cells past them hold PAD_SCORE."""
    if kind == "zero":
        S = np.zeros((B, L1, L2), np.int16)
    elif kind == "const":
        S = np.full((B, L1, L2), -3, np.int16)
    else:
        S = rng.randint(-600, 900, (B, L1, L2)).astype(np.int16)
        w = min(L1, L2)
        S[:, np.arange(w), np.arange(w)] += 1500
    l1 = rng.randint(1, L1 + 1, B).astype(np.int32)
    l2 = rng.randint(1, L2 + 1, B).astype(np.int32)
    l1[0], l2[-1] = 1, 1
    l1[B // 2], l2[B // 2] = L1, L2
    for b in range(B):
        S[b, l1[b]:, :] = PAD_SCORE
        S[b, :, l2[b]:] = PAD_SCORE
    return S, l1, l2


SW_WINDOW_KINDS = ("rand", "gaps", "ties")


def sw_windows(rng, B, L, kind="rand"):
    """(S (B, L, L) int16, l1 (B,) int32, l2 (B,) int32) for
    ops/sw_bits.sw_forward_bits: hit windows of a square pow2 bucket, as
    sw_traceback_batch packs them.

    rand   integer scores -60..24 with a planted positive diagonal in most
           windows (tests/test_sw_bits.py's random windows)
    gaps   -10 everywhere but two diagonal segments of 50 offset by a
           gap, which force E/F states and gap-open/extend ties
           (tests/test_sw_bits.py's gap windows)
    ties   scores in {-1, 0, 1}: equal cells and equal paths everywhere

    Sizes are ragged down to 1 x 1 (the first window), the middle window
    fills the bucket, and cells past a window hold PAD_SCORE."""
    if kind == "ties":
        S = rng.randint(-1, 2, (B, L, L)).astype(np.int16)
    elif kind == "gaps":
        S = np.full((B, L, L), -10, np.int16)
        for b in range(B):
            d1, off = rng.randint(3, max(4, L // 4)), rng.randint(2, 8)
            i = np.arange(d1)
            S[b, i, i] = 50
            i = np.arange(d1, L - off)
            S[b, i, i + off] = 50
    else:
        S = rng.randint(-60, 25, (B, L, L)).astype(np.int16)
        planted = rng.rand(B) < 0.8
        S[np.ix_(planted, np.arange(L), np.arange(L))] += np.where(
            np.eye(L, dtype=bool), rng.randint(20, 80, (L, L)), 0).astype(np.int16)
    l1 = rng.randint(1, L + 1, B).astype(np.int32)
    l2 = rng.randint(1, L + 1, B).astype(np.int32)
    l1[0], l2[0] = 1, 1
    l1[B // 2], l2[B // 2] = L, L
    for b in range(B):
        S[b, l1[b]:, :] = PAD_SCORE
        S[b, :, l2[b]:] = PAD_SCORE
    return S, l1, l2


PROSTT5_VOCAB_ROWS = 150  # the published ProstT5 vocab_size


def prostt5_hf_tensors(cfg, draw, rows=PROSTT5_VOCAB_ROWS, classifier=True):
    """{HF name: tensor} of a synthetic ProstT5 checkpoint in the real
    layout at the geometry of `cfg` (models/prostt5.T5Config):
    original-T5 names (`wi`, or `wi_0`/`wi_1` where cfg.ff is
    "gated-gelu"), a `rows`-row shared.weight and, with `classifier`, the
    foldseek head's conv2d tensors (out, in, K, 1).  `draw(shape, scale,
    shift)` returns one tensor of `shape` drawn from N(shift, scale^2):
    products and convolutions are fan-in scaled, RMSNorm weights
    1 + 0.1 N(0, 1)."""
    from unicore_tpu_torch.models.prostt5 import _HF_LAYER

    D, F, inner = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.d_kv
    H, K = cfg.cnn_hidden, cfg.cnn_kernel

    def w(*shape):
        return draw(shape, math.prod(shape[1:]) ** -0.5, 0.0)

    def norm():
        return draw((D,), 0.1, 1.0)

    t = {"shared.weight": draw((rows, D), 1.0, 0.0),
         "encoder.final_layer_norm.weight": norm(),
         "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
             draw((cfg.rel_buckets, cfg.n_heads), 0.5, 0.0)}
    ffn = ("wi0", "wi1") if cfg.ff == "gated-gelu" else ("wi",)
    shapes = {"q": (inner, D), "k": (inner, D), "v": (inner, D), "o": (D, inner), "wo": (D, F)}
    shapes.update({name: (F, D) for name in ffn})
    for i in range(cfg.n_layers):
        pre = f"encoder.block.{i}.layer."
        for name in ("ln1", "q", "k", "v", "o", "ln2", "wo") + ffn:
            t[pre + _HF_LAYER[name] + ".weight"] = norm() if name.startswith("ln") else w(*shapes[name])
    if classifier:
        t["classifier.0.weight"] = w(H, D, K, 1)
        t["classifier.0.bias"] = draw((H,), 0.1, 0.0)
        t["classifier.3.weight"] = w(cfg.n_classes, H, K, 1)
        t["classifier.3.bias"] = draw((cfg.n_classes,), 0.1, 0.0)
    return t


def prostt5_train_state(cfg, seed: int, device):
    """A float32 ProstT5 state (models/prostt5.py names) at `cfg`'s
    geometry drawn on `device` from a seeded torch.Generator, as
    prostt5_hf_tensors draws: products and convolutions fan-in scaled,
    RMSNorm weights 1 + 0.1 N(0, 1), embedding N(0, 1), rel_bias 0.5 N(0,
    1), conv biases 0.1 N(0, 1).  The same seed gives the same state on
    the same kind of device, in any process."""
    import torch

    from unicore_tpu_torch.models.prostt5 import ProstT5

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ProstT5(cfg, cfg.ff == "gated-gelu").state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for name, shape in shapes.items():
        x = torch.randn(*shape, generator=gen, device=device)
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") or name.endswith("final_ln.weight"):
            x = x.mul_(0.1).add_(1.0)
        elif name.endswith("bias"):
            x = x.mul_(0.1)
        elif name == "encoder.rel_bias.weight":
            x = x.mul_(0.5)
        elif name != "encoder.embed.weight":
            x = x.mul_(float(np.prod(shape[1:])) ** -0.5)
        state[name] = x
    return state


def write_prostt5_json(path, cfg, prefix_id=None, rows=PROSTT5_VOCAB_ROWS):
    """The HF config.json of `cfg`'s geometry in directory `path` and,
    given `prefix_id`, added_tokens.json with <AA2fold> at that id and
    <fold2AA> after it."""
    import json

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"d_model": cfg.d_model, "d_kv": cfg.d_kv, "num_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                   "num_layers": cfg.n_layers, "relative_attention_num_buckets": cfg.rel_buckets,
                   "relative_attention_max_distance": cfg.rel_max_dist,
                   "feed_forward_proj": "gated-gelu" if cfg.ff == "gated-gelu" else "relu",
                   "vocab_size": rows}, f)
    if prefix_id is not None:
        with open(os.path.join(path, "added_tokens.json"), "w") as f:
            json.dump({"<AA2fold>": prefix_id, "<fold2AA>": prefix_id + 1}, f)
