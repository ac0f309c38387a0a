"""The check that decides `correct`, at the tiny configuration on the CPU:
the program within its limit, the control (the reference computed in
fp8) and the faults a createdb cell can have outside it, and a run with
each fault planted under the timed path coming out not correct: in the
served codes, in the batch, in the head's mask, in the norm weights and
the head's biases, and in the stitching of windows."""

import time

import numpy as np
import pytest
import torch

from port_bench import generator, harness

SEEDS = [3, 4, 5]


def driver(spec, cfg, seed):
    _, _, traffic = harness.cell_files(spec, "createdb.eukaryote")
    mod = harness.load_module(f"{harness.HERE}/drivers/createdb.py", "createdb_driver")
    drv = mod.Driver(cfg, traffic, seed, "cpu")
    drv.build()
    return drv


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_program_passes(spec, tiny_cfg, seed):
    drv = driver(spec, tiny_cfg, seed)
    proteins = generator.draw_call(drv.mix, seed, 0)
    served = drv.run(proteins)
    r = drv.readings(proteins, served, control=True)
    limit = tiny_cfg["check"]["flip_gap_ratio"]
    faults = min(r["control"]["flip"], r["norm_fault"]["flip"], r["token_fault"]["flip"])
    assert r["program"]["flip"] <= limit * r["gauge"] < faults, r


def alter_token(orig):
    def fault(model, toks, mask):
        codes = orig(model, toks, mask).clone()
        codes[:, 1] = (codes[:, 1] + 1) % 20
        return codes
    return fault


def half_batch(orig):
    """The first half of the batch's proteins run, their codes served for
    the rest too."""
    def fault(model, toks, mask):
        h = max(1, int(mask.any(dim=1).sum()) // 2)
        codes = orig(model, toks[:h], mask[:h])
        return codes[np.arange(toks.shape[0]) % h]
    return fault


def skip_head_mask(orig):
    def fault(model, toks, mask):
        import torch

        with torch.inference_mode():
            return torch.argmax(model.head(model.encoder(toks, mask)), dim=-1)
    return fault


@pytest.mark.parametrize("fault", [alter_token, half_batch, skip_head_mask])
@pytest.mark.parametrize("cell", ["createdb.bacteria", "createdb.eukaryote"])
def test_planted_fault_is_not_correct(spec, tiny_cfg, monkeypatch, cell, fault):
    from unicore_tpu_torch.models import prostt5 as P

    monkeypatch.setattr(P, "predict_3di_codes", fault(P.predict_3di_codes))
    r = harness.run_cell(spec, cell, 2**31 + 13, 0.3, False, "cpu", time.perf_counter(), cfg=tiny_cfg)
    assert r["correct"] is False, r["compared"]


def norms_ignored(P, monkeypatch):
    """Every RMSNorm weight taken as 1."""
    orig = P.rms_norm
    monkeypatch.setattr(P, "rms_norm", lambda x, w, eps=1e-6: orig(x, torch.ones_like(w), eps))


def norms_swapped(P, monkeypatch):
    """Each block's attention normed by ln2 and its FFN by ln1."""
    def forward(self, x, bias_mask):
        x = x + P.self_attention(self.ln2(x), self.q.weight, self.k.weight, self.v.weight, self.o.weight,
                                 self.d_kv, bias_mask)
        return x + P.feed_forward(self.ln1(x), (self.wi.weight,), self.wo.weight)

    monkeypatch.setattr(P.T5Block, "forward", forward)


def biases_dropped(P, monkeypatch):
    """The head's convolutions without their biases."""
    import torch.nn.functional as F

    def forward(self, x, res_mask=None):
        m = None if res_mask is None else res_mask[:, None, :].float()
        y = x.float().transpose(1, 2)
        if m is not None:
            y = y * m
        y = torch.relu(F.conv1d(y, self.conv1.weight.float(), None, padding=self.conv1.padding))
        if m is not None:
            y = y * m
        return F.conv1d(y, self.conv2.weight.float(), None, padding=self.conv2.padding).transpose(1, 2)

    monkeypatch.setattr(P.CNNHead, "forward", forward)


@pytest.mark.parametrize("fault", [norms_ignored, norms_swapped, biases_dropped])
@pytest.mark.parametrize("cell", ["createdb.bacteria", "createdb.eukaryote"])
def test_weight_fault_is_not_correct(spec, tiny_cfg, monkeypatch, cell, fault):
    from unicore_tpu_torch.models import prostt5 as P

    fault(P, monkeypatch)
    r = harness.run_cell(spec, cell, 2**31 + 29, 0.3, False, "cpu", time.perf_counter(), cfg=tiny_cfg)
    assert r["correct"] is False, r["compared"]


def test_windows_stitched_wrong_is_not_correct(spec, tiny_cfg, monkeypatch):
    """Each window's letters one residue off where they are stitched."""
    from unicore_tpu_torch.models import prostt5 as P

    orig = P.ProstT5Engine._predict_units

    def units(self, sequences):
        out = orig(self, sequences)
        return [s[1:] + s[:1] if len(s) == self.max_window else s for s in out]

    monkeypatch.setattr(P.ProstT5Engine, "_predict_units", units)
    r = harness.run_cell(spec, "createdb.eukaryote", 17, 0.3, False, "cpu", time.perf_counter(), cfg=tiny_cfg)
    assert r["correct"] is False, r["compared"]
