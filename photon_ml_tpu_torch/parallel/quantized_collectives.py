"""Quantized collectives: int8 wire traffic, f32 math.

Port of ``photon_ml_tpu/parallel/quantized_collectives.py:62-187``
(EQuARX, arXiv 2306.08585): blockwise-scaled int8 with full-precision
accumulation, for the traffic that dominates a sharded GAME run — the
entity-sharded score exchange's sample-axis partials and the sharded
weight update's iterate gather.

- :func:`quantize_blockwise` / :func:`dequantize_blockwise` give the JAX
  package's int8 values and scales bit for bit: per-block absmax scale
  ``absmax * f32(1/127)``, round half to even, clip to +-127.
- :func:`qpsum` is ``collectives.psum`` with an optional int8 payload:
  each shard's partial is quantized, the int8 blocks and f32 scales are
  gathered (the compressed wire), and every shard dequantizes and sums
  the K partials in f32, in shard order.
- :func:`qall_gather` is a tiled all-gather of a 1-D shard in the same
  wire format, dequantized on arrival.

Mode ``"none"`` (the default) is the plain collective. Payloads smaller
than one block (every scalar reduction of the solvers) take it as well: a
4-byte partial cannot compress.

Accounting is on the host at the dispatch sites
(:func:`record_collective_bytes`), on the ``collective_bytes{site,mode}``
counter: per-device payload bytes per round, a lower bound counted the
same way in both modes, so their ratio is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.parallel.collectives import all_gather, psum

Tensor = torch.Tensor

#: Wire-format modes for the quantized collective wrappers.
QUANT_MODES = ("none", "int8")

#: Elements per quantization block (one f32 scale per block).
QUANT_BLOCK = 256

_INV_127 = float(np.float32(1.0 / 127.0))
_F32_TINY = float(np.finfo(np.float32).tiny)


def check_quant_mode(mode: str) -> str:
    """Validate a ``--collective-quant`` value; returns it for chaining."""
    if mode not in QUANT_MODES:
        raise ValueError(
            f"unknown collective-quant mode {mode!r}; "
            f"expected one of {QUANT_MODES}")
    return mode


def quantize_blockwise(x: Tensor, block: int = QUANT_BLOCK
                       ) -> tuple[Tensor, Tensor]:
    """Flatten and zero-pad ``x`` to blocks of ``block`` and quantize each
    to int8 with a per-block absmax scale: ``(q [nb, block] int8,
    scale [nb] f32)``. A zero block has scale 0 and quantizes to zeros."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    scale = absmax * torch.tensor(_INV_127, dtype=torch.float32,
                                  device=x.device)
    safe = torch.clamp(scale, min=_F32_TINY)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_blockwise(q: Tensor, scale: Tensor) -> Tensor:
    """int8 blocks and their scales back to f32 (``[..., nb, block]``)."""
    return q.to(torch.float32) * scale[..., None]


def _engages(x: Tensor, mode: str, block: int) -> bool:
    return mode == "int8" and x.numel() >= block


def _sum_shards(deq: Tensor) -> Tensor:
    acc = deq[0]
    for k in range(1, deq.shape[0]):
        acc = acc + deq[k]
    return acc


def qpsum(x, axis_name, mode: str = "none",
          block: int = QUANT_BLOCK):
    """``psum(x, axis_name)`` with optional int8 wire compression; None
    axis: ``x`` itself. int8 ships ``ceil(n / block)`` int8 blocks and
    their f32 scales, then every shard dequantizes and sums the K partials
    in f32 in shard order: the same result on every shard."""
    if axis_name is None:
        return x
    x = torch.as_tensor(x)
    if not _engages(x, check_quant_mode(mode), block):
        return psum(x, axis_name)
    q, scale = quantize_blockwise(x, block)
    q_all = all_gather(q, axis_name)  # [K, nb, block] int8
    scale_all = all_gather(scale, axis_name)  # [K, nb] f32
    total = _sum_shards(dequantize_blockwise(q_all, scale_all))
    return total.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def qall_gather(x: Tensor, axis_name, mode: str = "none",
                block: int = QUANT_BLOCK) -> Tensor:
    """Tiled all-gather of a 1-D shard with optional int8 wire
    compression; every shard dequantizes the same bytes, so the full
    vector is identical on all of them."""
    if axis_name is None:
        return x
    if x.dim() != 1 or not _engages(x, check_quant_mode(mode), block):
        return all_gather(x, axis_name, tiled=True)
    n = x.shape[0]
    q, scale = quantize_blockwise(x, block)
    deq = dequantize_blockwise(all_gather(q, axis_name),
                               all_gather(scale, axis_name))
    k = deq.shape[0]
    return deq.reshape(k, -1)[:, :n].reshape(-1).to(x.dtype)


def collective_payload_bytes(num_elements: int, itemsize: int = 4,
                             mode: str = "none",
                             block: int = QUANT_BLOCK) -> int:
    """Per-device wire payload of one collective round: int8 counts the
    quantized blocks and their f32 scales; sub-block payloads ship plain,
    as the wrappers do."""
    n = int(num_elements)
    if check_quant_mode(mode) == "int8" and n >= block:
        nblocks = -(-n // block)
        return nblocks * block + nblocks * 4
    return n * int(itemsize)


def record_collective_bytes(site: str, mode: str, num_elements: int,
                            itemsize: int = 4, rounds: int = 1,
                            block: int = QUANT_BLOCK,
                            registry: MetricsRegistry = REGISTRY) -> int:
    """Count ``rounds`` rounds of the payload on
    ``collective_bytes{site,mode}``; ``mode`` is the effective format (an
    int8 request of a sub-block payload ships, and is labelled, plain).
    Returns the bytes counted."""
    effective = ("int8" if check_quant_mode(mode) == "int8"
                 and int(num_elements) >= block else "none")
    nbytes = collective_payload_bytes(num_elements, itemsize, mode,
                                      block) * max(0, int(rounds))
    if nbytes:
        registry.counter("collective_bytes").inc(nbytes, site=site,
                                                 mode=effective)
    return nbytes
