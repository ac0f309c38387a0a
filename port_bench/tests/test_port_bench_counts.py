"""The FLOP and byte counts and the windows against hand counts, and the
generator's lengths."""

import numpy as np
import pytest

from port_bench import counts, generator

XL = {"d_model": 1024, "d_ff": 16384, "num_heads": 32, "d_kv": 128, "num_layers": 24,
      "feed_forward_proj": "relu", "cnn_hidden": 32, "cnn_kernel": 7, "n_classes": 20}


def test_layer_flops_by_hand():
    # one unit of 300 residues, n = 302: q, k, v, o are 4 products of
    # 1024 x 4096, wi and wo 2 of 1024 x 16384, 2 FLOPs a multiply-add
    n = 302
    proj = 4 * 2 * n * 1024 * 4096
    ffn = 2 * 2 * n * 1024 * 16384
    attn = 2 * 2 * 32 * n * n * 128  # q·kᵀ and probs·v
    assert counts.layer_flops(n, XL) == proj + ffn + attn
    head = 2 * 300 * 7 * 1024 * 32 + 2 * 300 * 7 * 32 * 20
    assert counts.head_flops(300, XL) == head
    assert counts.model_flops([300], XL) == 24 * (proj + ffn + attn) + head


def test_windows_by_hand():
    assert counts.windows(2048, 2048, 256) == [(0, 2048)]
    # 5,000 residues: starts 0, 1,792, then the last one ending at 5,000
    assert counts.windows(5000, 2048, 256) == [(0, 2048), (1792, 2048), (2952, 2048)]
    own = counts.owners(5000, 2048, 256)
    assert own[:1920] == [0] * 1920 and own[1920:3712] == [1] * 1792 and own[3712:] == [2] * 1288
    assert counts.unit_residues([100, 5000], 2048, 256) == [100, 2048, 2048, 2048]


def test_gemm_and_attention_cost_by_hand():
    flops, nbytes = counts.gemm_cost([4096, 1024], [1024, 16384], 2, 2)
    assert flops == 2 * 4096 * 1024 * 16384
    assert nbytes == 2 * (4096 * 1024 + 1024 * 16384 + 4096 * 16384)
    assert counts.gemm_cost([8, 64, 32], [8, 32, 16], 2, 4) == (2 * 8 * 64 * 32 * 16,
                                                                 8 * (64 * 32 + 32 * 16) * 2 + 8 * 64 * 16 * 4)
    with pytest.raises(ValueError):
        counts.matmul_dims([4, 5], [6, 7])
    flops, nbytes = counts.attention_cost(16, 32, 2176, 128)
    assert flops == 4 * 16 * 32 * 2176 ** 2 * 128
    assert nbytes == 4 * 16 * 32 * 2176 * 128 * 2 + 32 * 2176 ** 2 * 4 + 16 * 2176


def test_bound_and_peaks():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops_per_s"] == 989e12 and pk["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks("a card not in the table") is None
    assert counts.bound_s(989e12, 1.0, pk) == (1.0, "compute")
    assert counts.bound_s(1.0, 3.35e12, pk) == (1.0, "memory")


def test_law_lengths_are_quantiles():
    law = {"kind": "lognormal", "median": 300, "sigma": 0.65, "min": 50, "max": 2000}
    ls = generator.law_lengths(law, 2000)
    assert ls.min() >= 50 and ls.max() <= 2000 and np.all(np.diff(ls) >= 0)
    assert abs(np.median(ls) - 300) <= 1
    euk = generator.law_lengths({"kind": "lognormal", "median": 400, "sigma": 0.75, "min": 50, "max": 5000}, 1000)
    assert 0.01 <= np.mean(euk > 2048) <= 0.02


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, 2**40 + 3])
def test_calls_of_any_seed_hold_the_same_lengths(seed):
    m = {"length_law": {"kind": "lognormal", "median": 300, "sigma": 0.65, "min": 50, "max": 2000},
         "proteins_per_call": 200, "composition": {"A": 8.0, "L": 10.0, "W": 1.0}}
    call = generator.draw_call(m, seed, 1)
    assert sorted(map(len, call)) == generator.law_lengths(m["length_law"], 200).tolist()
    assert set("".join(call)) <= {"A", "L", "W"}
