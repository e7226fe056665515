"""Cross-pod gradient reduction with compression.

The port of ``repro/runtime/crosspod.py``.  Within a pod, gradients reduce
over the fast links in full precision; *across* pods the link is slow, so
the ``pod``-axis reduction is an explicit ``torch.distributed`` all-reduce
over the pod dimension's group, and the payload is compressed first (bf16,
or int8 with error feedback, :mod:`repro_torch.optim.compress`).  This is
the paper's NETCost lever: the network transfer shrinks by the compression
ratio, as a combiner shrinks shuffle bytes.

For int8, every pod first takes the MAX of each leaf's ``|g + err|`` (one
scalar a leaf), so that all pods quantize with one shared scale and the
SUM of their int32 payloads dequantizes exactly once.  For bf16 the
payloads are the bf16-rounded gradients, all-reduced in bf16 as the
reference does (2 bytes an element on NCCL).  gloo has no bf16 SUM, so on
a gloo group they are summed in fp32 and rounded back to bf16: 4 bytes an
element there (the reference's own test holds the result at atol 1e-2, as
the port's does).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.sharding import mesh_axes
from repro_torch.optim.compress import compress_grads, decompress_grads

__all__ = ["crosspod_reduce"]


def crosspod_reduce(grads: dict, err: dict | None, mesh, *, method: str = "bf16",
                    axis: str = "pod"):
    """Mean-reduce ``grads`` (plain tensors by name, identical within a pod)
    over the ``axis`` dimension of ``mesh`` with compressed payloads.

    Returns (reduced grads, new error state); (grads, err) unchanged when
    the mesh has no such axis or it has size 1.
    """
    npods = mesh_axes(mesh).get(axis, 1)
    if npods == 1:
        return grads, err
    group = mesh.get_group(axis)
    if method == "int8":
        red, new_err = {}, {}
        for k, g in grads.items():
            corrected = g.to(torch.float32) + err[k]
            amax = torch.clamp(corrected.abs().max(), min=1e-12)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            scale = amax / 127.0
            q = torch.clamp(torch.round(corrected / scale), -127, 127)
            payload = q.to(torch.int32)
            dist.all_reduce(payload, group=group)
            red[k] = (payload.to(torch.float32) * scale / npods).to(g.dtype)
            new_err[k] = corrected - q * scale
        return red, new_err
    comp, new_err = compress_grads(grads, err, method)
    widen = dist.get_backend(group) == "gloo"
    summed = {}
    for k, c in comp.items():
        buf = c.to(torch.float32, copy=True) if widen else c.clone()
        dist.all_reduce(buf, group=group)
        summed[k] = (buf / npods).to(c.dtype)
    return decompress_grads(summed, grads, method), new_err
