"""ProstT5 weights made on the device from the seed.

One `torch.Generator` on the device draws each kind of tensor for all
layers in one call, in the type the model is served in, at the scales of
the engine's own seeded initialization (`_init_tree`: 1/sqrt(fan-in) of
JAX's (in, out) layout; the embedding 1.0, the relative bias 0.1, each
convolution 1/sqrt(7) of its (kernel, in, out) layout), except in three
things.  q is drawn at T5's own (d_model · d_kv)^-1/2 (Mesh TensorFlow's,
and HF's `T5PreTrainedModel._init_weights`), since T5 leaves the
1/sqrt(d_kv) out of its scores.  At the engine's d_model^-1/2 the
scores' spread is sqrt(d_kv) ≈ 11, each softmax all but one-hot, and 24
such layers so sensitive that bf16 rounding alone changes 37 % of the
3Di letters against float32: no comparison could then tell bf16 from
fp8.  Each RMSNorm weight (ln1 and ln2 of every layer, the final norm)
is drawn on its own, 1 + 0.1·N(0, 1), where the engine sets ones.  Each
convolution's bias is N(0, 1) at a tenth of the spread of the
convolution's output, where the engine sets zeros; for unit-RMS inputs
that spread is sqrt(d_model) after conv1 and sqrt(cnn_hidden · d_model
/ 2) after the ReLU and conv2.  So a program that ignores a norm weight,
takes another layer's, or drops a bias serves other letters.
The state is named as the engine's `build_model` takes
it; each layer's tensors are views of the stacked draws.  Nothing is
written to disk.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench import generator


def device_state(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(generator.seed_key(seed))
    NL, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    inner = m["num_heads"] * m["d_kv"]
    C, K, V = m["cnn_hidden"], m["cnn_kernel"], m["n_classes"]

    def draw(*shape, scale):
        return torch.randn(*shape, generator=g, device=device, dtype=dtype).mul_(scale)

    qkv = draw(NL, 3, inner, D, scale=1 / math.sqrt(D))
    qkv[:, 0].mul_(1 / math.sqrt(m["d_kv"]))
    o = draw(NL, D, inner, scale=1 / math.sqrt(inner))
    wi = draw(NL, F, D, scale=1 / math.sqrt(D))
    wo = draw(NL, D, F, scale=1 / math.sqrt(F))
    norms = draw(NL * 2 + 1, D, scale=0.1).add_(1.0)
    st = {
        "encoder.embed.weight": draw(m["vocab_size"], D, scale=1.0),
        "encoder.rel_bias.weight": draw(m["relative_attention_num_buckets"], m["num_heads"], scale=0.1),
        "encoder.final_ln.weight": norms[2 * NL],
        "head.conv1.weight": draw(C, D, K, scale=1 / math.sqrt(K)),
        "head.conv1.bias": draw(C, scale=0.1 * math.sqrt(D)),
        "head.conv2.weight": draw(V, C, K, scale=1 / math.sqrt(K)),
        "head.conv2.bias": draw(V, scale=0.1 * math.sqrt(C * D / 2)),
    }
    for i in range(NL):
        pre = f"encoder.blocks.{i}."
        st.update({pre + "q.weight": qkv[i, 0], pre + "k.weight": qkv[i, 1], pre + "v.weight": qkv[i, 2],
                   pre + "o.weight": o[i], pre + "wi.weight": wi[i], pre + "wo.weight": wo[i],
                   pre + "ln1.weight": norms[2 * i], pre + "ln2.weight": norms[2 * i + 1]})
    return st
