"""Checks of the port that need a CUDA card; each skips, with its reason,
where there is none.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  On the card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention


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
