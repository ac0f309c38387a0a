"""The ProstT5 model on the card against the same calls on the CPU, with
every lower-precision setting a caller could leave on (TF32 in cuBLAS
and cuDNN, bf16 split-K reductions): the model's guard
(models/prostt5.py::full_precision) must keep them out and restore them.

Tolerances: those of tests/test_torch_prostt5.py (port against JAX), as
the card and the CPU sum the same float32 products in another order:
hidden states and logits within rtol 1e-4 and atol 1e-4 max|ref|; bf16
3Di strings under the tie rule (torch_port_helpers.assert_same_3di),
with the CPU's logits as the reference, and bf16 logits of one batch
within assert_bf16_spread of the CPU's (on the card the score
product of a bf16 model takes its own route, a bf16 GEMM with a float32
output).

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prostt5_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_bf16_spread, assert_same_3di, need_cuda, write_prostt5_checkpoint
from unicore_tpu_torch.models import prostt5 as T

RTOL = 1e-4
pytestmark = pytest.mark.cuda
LETTERS = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture
def low_precision():
    """Every lower-precision setting on, as a careless caller leaves them;
    afterwards the test checks they are still on, then they are restored."""
    mm = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    yield
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cudnn.allow_tf32 and mm.allow_bf16_reduced_precision_reduction
    torch.set_float32_matmul_precision(prev[0])
    torch.backends.cudnn.allow_tf32 = prev[1]
    mm.allow_bf16_reduced_precision_reduction = prev[2]


def _seqs(seed, lengths):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(LETTERS), n)) for n in lengths]


def _close(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_bucket_table_on_the_card():
    need_cuda()
    for L in (128, 2176):
        assert torch.equal(T._bucket_table(L, 32, 128, "cuda").cpu(), T._bucket_table(L, 32, 128))


def test_encoder_and_logits_cuda_vs_cpu_float32(tmp_path, low_precision):
    need_cuda()
    write_prostt5_checkpoint(tmp_path, "bin", dims=dict(d_model=256, d_kv=32, n_heads=8, d_ff=1024,
                                                        n_layers=4, cnn_hidden=32), seed=7)
    cfg = T.infer_config(str(tmp_path))
    state = T.load_params(str(tmp_path), cfg, dtype=torch.float32)
    cpu, gpu = T.build_model(cfg, state, "cpu"), T.build_model(cfg, state, "cuda")
    toks, mask = T.frame_batch(_seqs(1, [40, 300, 2, 510, 77, 9]), 512)
    tc, mc = torch.from_numpy(toks), torch.from_numpy(mask)
    tg, mg = tc.cuda(), mc.cuda()
    _close(T.encoder_forward(cpu, tc, mc).numpy()[mask], T.encoder_forward(gpu, tg, mg).cpu().numpy()[mask])
    res = (toks < T.TOK_PREFIX) & mask
    lc = T.residue_logits(cpu, tc, mc).numpy()
    _close(lc[res], T.residue_logits(gpu, tg, mg).cpu().numpy()[res])


def test_3di_cuda_vs_cpu_bfloat16(tmp_path, low_precision):
    """The engines in bf16 (the CLI's default) on several buckets, the
    windowed path included (max_window 256, overlap 64)."""
    need_cuda()
    write_prostt5_checkpoint(tmp_path, "safetensors", seed=8)
    seqs = _seqs(2, [33, 120, 2, 250, 600, 127, 1000])
    cpu = T.ProstT5Engine(str(tmp_path), device="cpu", max_window=256, overlap=64)
    gpu = T.ProstT5Engine(str(tmp_path), device="cuda", max_window=256, overlap=64)
    ref, got = cpu.predict(seqs), gpu.predict(seqs)

    def ref_logits(i):
        from torch_port_helpers import stitched_logits

        def unit(piece):
            toks, mask = T.frame_batch([piece], T._bucket_len(len(piece) + 2))
            lg = T.residue_logits(cpu.model, torch.from_numpy(toks), torch.from_numpy(mask))
            return lg.numpy()[0, 1:len(piece) + 1]
        return stitched_logits(seqs[i], unit, 256, 64)

    assert_same_3di(seqs, ref, got, ref_logits, "bfloat16")
    assert next(gpu.model.parameters()).device.type == "cuda"
    toks, mask = T.frame_batch([s for s in seqs if len(s) <= 254], 256)
    tc, mc = torch.from_numpy(toks), torch.from_numpy(mask)
    res = (toks < T.TOK_PREFIX) & mask
    f32 = T.build_model(cpu.cfg, T.load_params(str(tmp_path), cpu.cfg, dtype=torch.float32), "cpu")
    assert_bf16_spread(T.residue_logits(cpu.model, tc, mc).numpy()[res],
                       T.residue_logits(gpu.model, tc.cuda(), mc.cuda()).cpu().numpy()[res],
                       T.residue_logits(f32, tc, mc).numpy()[res])
