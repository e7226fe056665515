"""Checks of the port that need a CUDA card; each skips, with its reason,
where there is none.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  On the card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, gqa_decode_attention
from repro_torch.kernels.decode_attention import decode_attention_torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel it checks runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_flash_misaligned_bf16_on_the_card_raises(cuda_device):
    # the bf16 kernel's TMA loads need 16-byte-aligned addresses; q here is
    # contiguous but starts 2 bytes past one
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    q = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:]
    q = q.view(1, 4, 16, 16)
    assert q.data_ptr() % 16
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before


def _decode_inputs(device, dtype, B=2, H=8, KV=4, S=300, hd=128, seed=6):
    rng = np.random.default_rng(seed)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device, dtype)
                 for s in ((B, H, 1, hd), (B, KV, S, hd), (B, KV, S, hd)))
    slot_pos = torch.arange(S, dtype=torch.int32, device=device)
    return q, kc, vc, slot_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["q", "k_cache"])
def test_decode_misaligned_input_on_the_card_raises(cuda_device, dtype, which):
    # the kernel's 16-byte loads need 16-byte-aligned addresses; the input
    # here is contiguous but starts one element past one
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, dtype)
    args = {"q": q, "k_cache": kc}
    t = args[which]
    moved = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)[1:]
    args[which] = moved.view(t.shape).copy_(t)
    assert args[which].data_ptr() % 16
    pos = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    before = gqa_decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        gqa_decode_attention(args["q"], args["k_cache"], vc, slot_pos, pos,
                             layout="full")
    assert gqa_decode_attention.launches == before


@pytest.mark.cuda
def test_decode_call_captured_in_a_graph_replays_at_advancing_positions(cuda_device):
    # the merge counters must be back at 0 after every replay, and the
    # kernel must read pos on the device: three replays at three positions,
    # each held to the plain version
    q, kc, vc, slot_pos = _decode_inputs(cuda_device, torch.bfloat16)
    B, H, _, hd = q.shape
    KV = kc.shape[1]
    pos = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    kw = dict(window=None, logit_cap=50.0)
    gqa_decode_attention(q, kc, vc, slot_pos, pos, layout="full", **kw)  # build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gqa_decode_attention(q, kc, vc, slot_pos, pos, layout="full", **kw)
    for p in (40, 170, 299):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc,
                                      slot_pos, pos, **kw).view(B, H, 1, hd)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
