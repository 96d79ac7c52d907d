"""Delta compression codec: int8 quantization with per-block scales (port
of ``repro/optim/compression.py``).

The distributed engine's compressed wire formats
(``core.engine.Schedule(compress=...)``) send the Kaczmarz round delta and
the banded halo edges through the per-array helpers below: int8 blocks of
``BLOCK`` values with one f32 scale each, or a plain bf16 round.  The tree
forms (``quantize``, ``dequantize``, ``roundtrip``) apply the codec to
every tensor of a dict, list or tuple; ``compress_with_feedback`` carries
the quantization error into the next call (error feedback), so that no
update is lost over a long run.

The arithmetic is the reference's: the scale is the block's largest
magnitude over 127 (IEEE f32 division), the quantized value is
``round(x / max(scale, 1e-12))`` with ties to even, as ``jnp.round`` rounds
them, so on the same f32 input every function here returns the
reference's bits.  The codec is plain PyTorch: a few elementwise calls
and one reduction on the tensor's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "Compressed", "ErrorFeedback", "bf16_roundtrip_array",
           "compress_with_feedback", "dequantize", "dequantize_array",
           "init_error_feedback", "quantization_error_bound", "quantize",
           "quantize_array", "roundtrip", "roundtrip_array"]

BLOCK = 256


class Compressed(NamedTuple):
    q: Any          # int8 tree (each leaf padded to BLOCK multiples, flat)
    scales: Any     # f32 per-block scales
    shapes: Any     # the leaves' original shapes


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a dict / list / tuple tree (the leaves of
    ``rest`` taken at the same places)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _quantize_leaf(g: torch.Tensor):
    """(q, scales) of one tensor: int8 blocks of BLOCK with f32 scales."""
    flat = g.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, _pad_len(flat.numel()) - flat.numel()))
    flat = flat.reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(flat / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0]


def quantize(tree) -> Compressed:
    """Every tensor of ``tree`` as int8 blocks and f32 scales, one pass a
    leaf."""
    pairs = _tree_map(_quantize_leaf, tree)
    return Compressed(
        q=_tree_map(lambda g, p: p[0], tree, pairs),
        scales=_tree_map(lambda g, p: p[1], tree, pairs),
        shapes=_tree_map(lambda g: tuple(g.shape), tree))


def dequantize(c: Compressed, like):
    """The tensors of ``c`` back in the shapes and dtypes of ``like``."""
    def leaf(g, q, s):
        return dequantize_array(q, s, shape=g.shape, dtype=g.dtype)

    return _tree_map(leaf, like, c.q, c.scales)


def roundtrip(tree):
    """quantize -> dequantize (what the wire does to a tree)."""
    return dequantize(quantize(tree), tree)


# ---------------------------------------------------------------------------
# Per-array helpers: the engine's compressed-sync wire format
# ---------------------------------------------------------------------------

def quantize_array(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 blocks + f32 per-block scales of one tensor."""
    return _quantize_leaf(g)


def dequantize_array(q: torch.Tensor, scales: torch.Tensor, *, shape,
                     dtype=torch.float32) -> torch.Tensor:
    flat = q.to(torch.float32) * scales[:, None]
    size = 1
    for d in shape:
        size *= d
    return flat.reshape(-1)[:size].reshape(tuple(shape)).to(dtype)


def roundtrip_array(g: torch.Tensor) -> torch.Tensor:
    """What the int8 wire does to one tensor (quantize -> dequantize)."""
    q, s = _quantize_leaf(g)
    return dequantize_array(q, s, shape=g.shape, dtype=g.dtype)


def bf16_roundtrip_array(g: torch.Tensor) -> torch.Tensor:
    """What a bf16 wire does to one tensor (round to bf16, widen back)."""
    return g.to(torch.bfloat16).to(g.dtype)


def quantization_error_bound(g: torch.Tensor) -> torch.Tensor:
    """Elementwise worst-case int8 roundtrip error of ``g``: half the
    largest per-block scale (|dequant(quant(g)) - g| <= scale / 2)."""
    _, scales = _quantize_leaf(g)
    return scales.max() * 0.5


class ErrorFeedback(NamedTuple):
    residual: Any


def init_error_feedback(params) -> ErrorFeedback:
    return ErrorFeedback(residual=_tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_with_feedback(tree, ef: ErrorFeedback):
    """Error-feedback compression: quantize (g + residual) and carry the
    quantization error into the next call (Karimireddy et al.)."""
    corrected = _tree_map(lambda g, r: g.to(torch.float32) + r, tree,
                          ef.residual)
    sent = roundtrip(corrected)
    residual = _tree_map(lambda c, s: c - s.to(torch.float32), corrected,
                         sent)
    return sent, ErrorFeedback(residual=residual)
