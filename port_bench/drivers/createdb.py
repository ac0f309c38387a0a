"""The `createdb` driver: ProstT5's AA->3Di prediction on proteome calls.

The window drives `unicore_tpu_torch.models.prostt5.ProstT5Engine.predict`,
the call `modules/createdb.py::run` makes: sorting and length buckets,
batches, framing, the encoder and the CNN head, the argmax, decoding to
3Di letters, and windows stitched for proteins longer than a window.

Set-up makes the weights on the device (`weights.device_state`) and
hands them to an engine that drew nothing of the encoder: the engine is
built at `n_layers=0`, then its `cfg` and `model` are set to the full
configuration and `build_model(cfg, state, device)`.  It warms up with
one engine call per distinct batch shape that a call forms: the units of
the first batch of each shape, from a call of the window's lengths that
the window does not run (`batches` works out the engine's batches by its
rule: `_bucket_len`, `batch_tokens`, at most 512 and at least 8 units a
batch, rows padded to a multiple of 8).  Where the engine's counters show
a warm-up call forming another batch than that rule's, the rule no
longer holds and a whole call is the warm-up.  The warm-up's times give
a call's time, and set-up draws twice the calls the window needs by it
(`generator.draw_call`).  After the window, the batches the engine
formed are held against the rule's and a difference is logged.

`check` compares every protein's letters with its length and the 3Di
alphabet, and a sample drawn from the seed, the longest protein with it,
with the float32 reference (`reference/prostt5.py`): each residue's gap
between the reference's best logit and the logit of the letter the
program served, over the standard deviation of the sample's reference
logits.  The mean gap of the residues served another letter than the
reference's best, over the seed's gauge (`gauge`: how far the seed's
network carries a rounding), is `flip_gap_ratio`, held to the
configuration's limit.  Both steps take out what the seed's weights set
for the program and the control alike: the mean over all residues moves
with how many residues sit near a tie, and the flip gap with how much
the network amplifies an error.  The mean gap and the widest gap are
printed beside it; the widest swings from seed to seed by nature.
`readings` gives the same numbers with the gauge, and those of the
control (the reference computed in fp8), of the norm weights ignored,
and of a token altered where it is produced.
"""

from __future__ import annotations

import math
import time
from dataclasses import replace
from typing import Dict, List

import numpy as np

from port_bench import counts, generator, weights
from port_bench.harness import log as harness_log
from port_bench.reference import prostt5 as ref

RATE = "createdb_residues_per_s"
NO_READING = 1e30  # the gap where no protein could be compared


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.mix = generator.mix(cfg, traffic)
        self.pool: List[List[str]] = []
        self.engine = None
        self.state = None
        self.start = (0, 0)

    # -- set-up ---------------------------------------------------------

    def t5_config(self):
        from unicore_tpu_torch.models import prostt5 as P

        m = self.cfg
        return replace(P.T5Config(), d_model=m["d_model"], d_kv=m["d_kv"], n_heads=m["num_heads"],
                       d_ff=m["d_ff"], n_layers=m["num_layers"], vocab=m["vocab_size"],
                       rel_buckets=m["relative_attention_num_buckets"],
                       rel_max_dist=m["relative_attention_max_distance"], n_classes=m["n_classes"],
                       cnn_hidden=m["cnn_hidden"], cnn_kernel=m["cnn_kernel"], ff=m["feed_forward_proj"])

    def _sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def build(self):
        """Weights on the device and the engine; the set-up's split."""
        t = time.perf_counter()
        from unicore_tpu_torch.models import prostt5 as P

        split = [("program import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.engine = None
        self.state = weights.device_state(self.cfg, self.seed, self.device)
        self._sync()
        split.append(("weights on the device", time.perf_counter() - t))
        t = time.perf_counter()
        tcfg = self.t5_config()
        eng = P.ProstT5Engine(cfg=replace(tcfg, n_layers=0), device=self.device)
        eng.cfg = tcfg
        eng.model = P.build_model(tcfg, self.state, self.device)
        eng.max_window, eng.overlap = self.cfg["max_window"], self.cfg["overlap"]
        self.engine = eng
        split.append(("engine", time.perf_counter() - t))
        return split

    def batches(self, proteins: List[str]) -> List[List[str]]:
        """The units of `proteins` (their windows) in the engine's batches."""
        from unicore_tpu_torch.models import prostt5 as P

        c = self.cfg
        units = sorted((p[st : st + ln] for p in proteins
                        for st, ln in counts.windows(len(p), c["max_window"], c["overlap"])), key=len)
        out, i = [], 0
        while i < len(units):
            L = P._bucket_len(len(units[i]) + 2)
            bs = max(8, min(512, self.engine.batch_tokens // L))
            out.append([u for u in units[i : i + bs] if len(u) + 2 <= L])
            i += len(out[-1])
        return out

    @staticmethod
    def shape(batch: List[str]):
        from unicore_tpu_torch.models import prostt5 as P

        return -(-len(batch) // 8) * 8, P._bucket_len(len(batch[0]) + 2)

    def formed(self) -> tuple:
        c = self.counters()
        return c.get("prostt5.batches", 0), c.get("prostt5.padded_tokens", 0)

    def warm_up(self):
        """(seconds of a call by the warm-up's times, what was warmed)."""
        call = generator.draw_call(self.mix, self.seed, -1)
        batches = self.batches(call)
        took: Dict[tuple, float] = {}
        for b in batches:
            shape = self.shape(b)
            if shape in took:
                continue
            before, t = self.formed(), time.perf_counter()
            self.engine.predict(b)
            self._sync()
            took[shape] = time.perf_counter() - t
            after = self.formed()
            if (after[0] - before[0], after[1] - before[1]) != (1, shape[0] * shape[1]):
                harness_log(f"[setup] the engine formed {after[0] - before[0]:g} batches of "
                            f"{after[1] - before[1]:g} tokens for one of {shape}: a whole call warms up")
                t = time.perf_counter()
                self.engine.predict(call)
                self._sync()
                return time.perf_counter() - t, "a whole call"
        return sum(took[self.shape(b)] for b in batches), f"{len(took)} shapes of {len(batches)} batches"

    def setup(self, seconds: float):
        split = self.build()
        t = time.perf_counter()
        est, what = self.warm_up()
        split.append((f"warm-up, {what}", time.perf_counter() - t))
        t = time.perf_counter()
        n = math.ceil(2 * seconds / est) + 1
        self.pool = [generator.draw_call(self.mix, self.seed, i) for i in range(n)]
        split.append((f"{n} calls drawn (a call {est:.3f} s by the warm-up)", time.perf_counter() - t))
        self.start = self.formed()
        return split

    # -- the window -----------------------------------------------------

    def call(self, i: int) -> List[str]:
        return self.pool[i] if i < len(self.pool) else generator.draw_call(self.mix, self.seed, i)

    def run(self, proteins: List[str]) -> List[str]:
        return self.engine.predict(proteins)

    def end_to_end(self, calls, seconds: float) -> Dict[str, float]:
        residues = sum(len(s) for inputs, _ in calls for s in inputs)
        return {RATE: residues / seconds}

    def layer_context(self, calls) -> Dict:
        lengths = [len(s) for inputs, _ in calls for s in inputs]
        end, rule = self.formed(), [self.shape(b) for inputs, _ in calls for b in self.batches(inputs)]
        formed = (end[0] - self.start[0], end[1] - self.start[1])
        if formed != (len(rule), sum(r * L for r, L in rule)):
            harness_log(f"[window] the engine formed {formed[0]:g} batches of {formed[1]:g} tokens, the warm-up's "
                        f"rule {len(rule)} of {sum(r * L for r, L in rule)}: the warm-up may have missed shapes")
        return {"unit_residues": counts.unit_residues(lengths, self.cfg["max_window"], self.cfg["overlap"])}

    def counters(self) -> Dict[str, float]:
        from unicore_tpu_torch.runtime import profiling

        return profiling.get_counters()

    def release(self) -> None:
        self.engine = None

    # -- the check ------------------------------------------------------

    def sample(self, proteins: List[str]) -> List[int]:
        """Indices of the checked proteins: the longest, then proteins in
        an order drawn from the seed until `sample_residues` are held."""
        rng = np.random.default_rng([generator.seed_key(self.seed), 0xC4EC])
        longest = max(range(len(proteins)), key=lambda i: len(proteins[i]))
        out, held = [longest], len(proteins[longest])
        for i in rng.permutation(len(proteins)).tolist():
            if held >= self.cfg["check"]["sample_residues"]:
                break
            if i != longest:
                out.append(i)
                held += len(proteins[i])
        return out

    def reference(self, proteins: List[str], precision: str = "float32", state=None) -> List[np.ndarray]:
        c = self.cfg
        return ref.protein_logits(proteins, self.state if state is None else state, c, c["token_rows"],
                                  c["max_window"], c["overlap"], self.device, precision)

    def gaps(self, letters: List[str], logits: List[np.ndarray]) -> Dict[str, float]:
        """Each residue's gap between the reference's best logit and that
        of the served letter, over the std of the reference's logits: the
        widest ("max"), the mean, the share of residues served another
        letter than the reference's best ("mismatch"), and the mean gap
        of those residues ("flip"; 0 where there are none)."""
        classes = self.cfg["classes"]
        lg = np.concatenate(logits)
        served = np.array([classes.index(ch) for s in letters for ch in s])
        g = (lg.max(axis=1) - lg[np.arange(len(served)), served]) / lg.std()
        off = g[g > 0]
        return {"max": float(g.max()), "mean": float(g.mean()), "mismatch": float(off.size / g.size),
                "flip": float(off.mean()) if off.size else 0.0, "residues": int(len(g))}

    def gauge(self, proteins: List[str], f32: List[np.ndarray]) -> float:
        """The RMS of the logits' change when the reference rounds its
        residual stream to bfloat16, over the std of its float32 logits:
        how far this seed's network carries a rounding."""
        a, b = np.concatenate(f32), np.concatenate(self.reference(proteins, "bf16_stream"))
        return float(np.sqrt(np.mean(np.square(b - a))) / a.std())

    def check(self, calls) -> Dict:
        proteins = [s for inputs, _ in calls for s in inputs]
        served = [s for _, outputs in calls for s in outputs]
        alphabet = set(self.cfg["classes"])
        bad = {i for i, (p, s) in enumerate(zip(proteins, served))
               if not isinstance(s, str) or len(s) != len(p) or not set(s) <= alphabet}
        bad.update(range(len(served), len(proteins)))
        idx = [i for i in self.sample(proteins) if i not in bad]
        g = {"mean": NO_READING, "max": NO_READING, "mismatch": 1.0, "flip": NO_READING, "residues": 0}
        gauge = 1.0
        if idx:
            sub = [proteins[i] for i in idx]
            f32 = self.reference(sub)
            g, gauge = self.gaps([served[i] for i in idx], f32), self.gauge(sub, f32)
        ratio = g["flip"] / gauge if gauge > 0 else NO_READING
        harness_log(f"[check] {len(idx)} proteins, {g['residues']} residues: widest gap {g['max']:.6g}, "
                    f"mean gap {g['mean']:.6g}, letters off the reference's best {100 * g['mismatch']:.4f} %, "
                    f"their mean gap {g['flip']:.6g}, gauge {gauge:.6g}")
        limit = self.cfg["check"]["flip_gap_ratio"]
        return {"attempted": len(proteins), "failed": len(bad),
                "compared": [("failed_proteins", len(bad), 0), ("flip_gap_ratio", ratio, limit)],
                "correct": not bad and ratio <= limit}

    def readings(self, proteins: List[str], served: List[str], control: bool) -> Dict[str, Dict]:
        """The gaps of the sample of `proteins`: of the program's `served`
        letters; with `control`, also of the letters the fp8 reference
        puts first, of those the reference puts first with every RMSNorm
        weight taken as 1 (a norm weight ignored), and of the program's
        letters with the first residue of each protein served the next
        class (a token altered where it is produced)."""
        import torch

        idx = self.sample(proteins)
        sub = [proteins[i] for i in idx]
        f32 = self.reference(sub)
        mine = [served[i] for i in idx]
        out = {"program": self.gaps(mine, f32), "gauge": self.gauge(sub, f32)}
        if control:
            classes = self.cfg["classes"]

            def first(logits):
                return ["".join(classes[k] for k in lg.argmax(axis=1)) for lg in logits]

            out["control"] = self.gaps(first(self.reference(sub, "fp8")), f32)
            norms = ("ln1.weight", "ln2.weight", "final_ln.weight")
            flat = {k: torch.ones_like(v) if k.endswith(norms) else v for k, v in self.state.items()}
            out["norm_fault"] = self.gaps(first(self.reference(sub, state=flat)), f32)
            nxt = {c: classes[(k + 1) % len(classes)] for k, c in enumerate(classes)}
            out["token_fault"] = self.gaps([nxt[s[0]] + s[1:] for s in mine], f32)
        return out
