"""Device policy of the PyTorch port.

Every entry point of :mod:`repro_torch` that makes tensors takes
``device=None``, which means the CUDA card.  Without a card the entry point
raises unless the caller asked for the CPU explicitly (``device="cpu"``, as
the tests do): a run never carries on silently on the CPU.

Row-parallel work (the evaluators' chunks, the wave rollout's scenarios)
can also be split over several devices: :func:`search_devices` names them
(``devices=None`` means every visible CUDA card) and :func:`split_rows`
pads a batch to the device count, runs one contiguous block of rows on each
device and joins the blocks back in order — the port's counterpart of the
reference's ``shard_map`` over a 1-D ``"search"`` mesh.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

import torch

__all__ = ["has_cuda", "resolve_device", "search_devices", "split_rows"]


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def search_devices(devices: Sequence | None = None) -> list[torch.device]:
    """The devices row-parallel work is split over.

    ``None`` -> every visible CUDA device (raises without a card); an
    explicit list, such as ``["cpu"] * 4``, comes back as ``torch.device``s,
    each checked like :func:`resolve_device` checks one.
    """
    if devices is None:
        if not has_cuda():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] to run "
                "on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    return devs


def split_rows(
    fn: Callable[[dict[str, torch.Tensor], torch.device], Mapping[str, torch.Tensor]],
    arrs: Mapping[str, torch.Tensor],
    devices: Sequence[torch.device],
) -> dict[str, torch.Tensor]:
    """Run ``fn`` over a batch of rows split across ``devices``.

    ``arrs`` maps names to tensors sharing a leading row axis of length
    ``b``.  The batch is padded by repeating its last row
    until the row count is a multiple of ``len(devices)``, cut into one
    contiguous block per device, and ``fn(block, device)`` runs each block
    with its columns on that device (several devices in threads).  The
    outputs, which must keep the leading row axis, are joined in order on
    the first device and cut back to ``b`` rows.
    Rows are independent, so the result equals one call over the whole
    batch on one device.
    """
    devs = [torch.device(d) for d in devices]
    cols = dict(arrs)
    b = next(iter(cols.values())).shape[0]
    n = len(devs)
    pad = (-b) % n
    if pad:
        cols = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
                for k, v in cols.items()}
    per = (b + pad) // n

    def run(i: int) -> Mapping[str, torch.Tensor]:
        dev = devs[i]
        block = {k: v[i * per:(i + 1) * per].to(dev) for k, v in cols.items()}
        return fn(block, dev)

    if n == 1:
        parts = [run(0)]
    else:
        with ThreadPoolExecutor(max_workers=n) as pool:
            parts = list(pool.map(run, range(n)))
    return {k: torch.cat([p[k].to(devs[0]) for p in parts])[:b]
            for k in parts[0]}
