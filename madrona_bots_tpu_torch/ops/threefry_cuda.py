"""The threefry kernel's wrapper: jax's threefry2x32 in one launch of
`csrc/threefry.cu` a call.

`rng.py` calls these on CUDA tensors (and its `*_reference` functions, the
plain versions, on CPU tensors and wherever `use_kernels` is False):

- `threefry2x32(k0, k1, x0, x1)`: the hash over the broadcast of its operands,
  keys [*S, 2]; `fold_in` and `split` are `threefry2x32(k0, k1, 0, data)`.
- `words(key, n, offset)`: random words [*K, n] of keys [*K, 2].
- `categorical(key, logits, offset)`: the Gumbel-argmax draw, int64
  [*K, R], of keys [*K, 2] over contiguous f32 logits [*K, R, n].
- `gumbel(bits)`: the draw's noise of given words, for tests.

Every operand is read from device memory on the card, so a CUDA graph
holds the launches; outputs come from `torch.empty` on the current stream.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madrona_bots_tpu_torch.ops import _build

launches = 0
"""Launches of the threefry kernel since the count was last set to 0."""
launches_of = {"hash": 0, "words": 0, "categorical": 0, "gumbel": 0}
"""`launches` by entry point."""

MAX_DIMS = 8
"""The most dims of a hash's broadcast shape."""
_MASK32 = 0xFFFFFFFF
_VOID, _I64 = ctypes.c_void_p, ctypes.c_int64
_HASH_ARGS = [_VOID, _I64, _VOID, _VOID]
_WORDS_ARGS = [_VOID, _I64, _I64, _I64, _VOID, _VOID]
_CATEGORICAL_ARGS = [_VOID, _I64, _VOID, _I64, ctypes.c_int, _I64, _VOID, _VOID]
_GUMBEL_ARGS = [_VOID, _I64, _VOID, _VOID]


def _launch(entry: str, argtypes, dev: torch.device, *args) -> None:
    global launches
    fn = _build.function("threefry", f"mbots_threefry_{entry}", argtypes)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    launches += 1
    launches_of[entry] += 1


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"threefry kernel: {what} on {t.device}")
    return t.device


def _keys(key: torch.Tensor) -> torch.Tensor:
    if key.dtype != torch.int64 or key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"threefry kernel: keys must be int64 [..., 2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    return key.contiguous()


def threefry2x32(k0, k1, x0, x1) -> torch.Tensor:
    """threefry2x32 of uint32-valued operands (ints, or int32 / int64
    tensors on one CUDA device, of broadcastable shapes S): int64 [*S, 2]
    holding y0 and y1."""
    ops = [x.to(torch.int64) if isinstance(x, torch.Tensor)
           and x.dtype not in (torch.int32, torch.int64) else x for x in (k0, k1, x0, x1)]
    tensors = [t for t in ops if isinstance(t, torch.Tensor)]
    if not tensors:
        raise ValueError("threefry kernel: a hash of ints alone has no device")
    dev = _device(tensors[0], "the operands")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"threefry kernel: operands on {[str(t.device) for t in tensors]}")
    # Broadcast views (stride 0 along broadcast dims), alive until the launch
    # is enqueued; torch.broadcast_shapes would import sympy on first use.
    views = torch.broadcast_tensors(*tensors)
    shape = tuple(views[0].shape)
    if len(shape) > MAX_DIMS:
        raise ValueError(f"threefry kernel: {len(shape)} dims, at most {MAX_DIMS}")
    out = torch.empty(shape + (2,), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    pad = [0] * (MAX_DIMS - len(shape))
    desc, it = [len(shape), *shape, *pad], iter(views)
    for x in ops:
        if isinstance(x, torch.Tensor):
            e = next(it)
            desc += [e.data_ptr(), 0, e.element_size(), *e.stride(), *pad]
        else:
            desc += [0, int(x) & _MASK32, 0] + [0] * MAX_DIMS
    _launch("hash", _HASH_ARGS, dev, (ctypes.c_int64 * len(desc))(*desc),
            out.numel() // 2, out.data_ptr())
    return out


def words(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """Random words [*K, *shape] of keys [*K, 2]: word i (row-major) of key
    k is y0 ^ y1 of threefry(k, (0, offset + i))."""
    dev = _device(key, "the keys")
    key = _keys(key)
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(key.shape[:-1] + shape, dtype=torch.int64, device=dev)
    if out.numel():
        _launch("words", _WORDS_ARGS, dev, key.data_ptr(), key.numel() // 2, n,
                offset & _MASK32, out.data_ptr())
    return out


def categorical(key: torch.Tensor, logits: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The Gumbel-argmax draw of keys [*K, 2] over f32 logits [*K, ..., n]
    (n > 0) on the keys' CUDA device: int64 [*K, ...], element (r, j) of
    key k (r the row-major row) drawn at counter offset + r * n + j of k's
    draw."""
    kd = key.dim() - 1
    if not (key.is_cuda and logits.device == key.device and logits.dtype == torch.float32
            and logits.dim() > kd and logits.shape[:kd] == key.shape[:-1]
            and logits.shape[-1] > 0):
        raise ValueError(f"threefry kernel: CUDA keys [*K, 2] and f32 logits [*K, ..., n > 0] "
                         f"on their device, got keys {tuple(key.shape)} on {key.device}, "
                         f"logits {logits.dtype} {tuple(logits.shape)} on {logits.device}")
    dev, key = key.device, _keys(key)
    logits = logits.contiguous()
    width = logits.shape[-1]
    out = torch.empty(logits.shape[:-1], dtype=torch.int64, device=dev)
    if out.numel():
        _launch("categorical", _CATEGORICAL_ARGS, dev, key.data_ptr(),
                key.numel() // 2, logits.data_ptr(), out.numel() // max(key.numel() // 2, 1),
                width, offset & _MASK32, out.data_ptr())
    return out


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """The draw's Gumbel noise, f32, of each uint32 word of an int64 tensor."""
    dev = _device(bits, "the words")
    if bits.dtype != torch.int64:
        raise ValueError(f"threefry kernel: int64 words, got {bits.dtype}")
    bits = bits.contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=dev)
    if out.numel():
        _launch("gumbel", _GUMBEL_ARGS, dev, bits.data_ptr(), out.numel(),
                out.data_ptr())
    return out
