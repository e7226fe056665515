"""``flash_attention`` on Hopper: the CUDA kernel's launcher, its launch
geometry, and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the reference package's
Pallas kernel ``repro/kernels/flash_attention.py::flash_attention_kernel``:
blocked online-softmax GQA attention with causal, sliding-window, softcap,
``q_offset`` and ``k_len`` masks, m, l and acc in fp32.  The source says how
its design differs from the TPU's and what bounds it.  It takes the head
dim as it is: no lane padding of hd to 128 and no padding of the sequence to
a block multiple, which were the TPU's needs; the kernel masks the ragged
edge itself.

:func:`flash_attention_torch` is the plain PyTorch version of the same
function.  It materialises the scores, as the reference's oracle
``repro/kernels/ref.py::flash_attention_ref`` does.  The CPU path of
:func:`repro_torch.kernels.flash_attention` and the tests use it; on the
card it is the yardstick the kernel is held to.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import LaunchSpec, check, load

__all__ = ["coverage", "flash_attention_cuda", "flash_attention_torch",
           "launch_spec"]

ROWS = 32          # (query row, head) pairs per CTA
BLOCK_K = 32       # keys per shared-memory tile
THREADS = 256
_NEG = -1e30

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}


def launch_spec(B: int, H: int, KV: int, Sq: int, hd: int) -> LaunchSpec:
    """The kernel's launch: one CTA per 32 (query row, head) pairs of one
    (batch, kv head); q rows and one K and one V tile of 32 keys in fp32
    shared memory, each row padded to hd + 4 floats."""
    G = H // KV
    return LaunchSpec(
        grid=(-(-Sq * G // ROWS), KV, B), block=(THREADS, 1, 1),
        smem_bytes=(ROWS + 2 * BLOCK_K) * (hd + 4) * 4)


def coverage(B: int, H: int, KV: int, Sq: int
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z): the Sq * G
    (query row, head) pairs of a kv group, the KV kv heads and the B batch
    rows; and what one CTA covers of them: 32 pairs of one (batch, kv head).
    The kernel masks the pairs past Sq * G."""
    return (Sq * (H // KV), KV, B), (ROWS, 1, 1)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    window: int | None, logit_cap: float | None, q_offset: int, k_len: int,
    spec: LaunchSpec,
) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.

    Callers go through :func:`repro_torch.kernels.flash_attention`, which
    checks shapes, types, devices and the launch's shared memory.
    """
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = load("flash_attention", _SIGNATURES)
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KV, Sq, Sk, hd, hd ** -0.5, int(causal), window or 0,
                 logit_cap or 0.0, q_offset, k_len, spec.smem_bytes, stream)
    check(err, "flash_attention")
    return out


def flash_attention_torch(
    q: torch.Tensor,            # (B, H, Sq, hd)
    k: torch.Tensor,            # (B, KV, Sk, hd)
    v: torch.Tensor,            # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    k_len: int | None = None,
) -> torch.Tensor:
    """Plain version: scores (B, KV, G, Sq, Sk), masked, softmax, P.V, all
    in fp32 from inputs cast to fp32 and rounded once at the end, as the
    kernel (and the reference's Pallas kernel) computes them.

    Masked keys get probability 0, as in the kernel, so a row with no
    visible key is 0; a row with one is the reference's softmax.
    """
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bngqh,bnch->bngqc", qg, k.float()) * hd ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if k_len is not None:
        ok &= k_pos[None, :] < k_len
    s = s.masked_fill(~ok, _NEG)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngqc,bnch->bngqh", w, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
