"""Learner-row compaction: slot indices, gather, expansion, bf16 payloads.

Counterpart of `madrona_bots_tpu/learn/pack.py`. The JAX package moves rows
with one-hot contractions (a TPU stand-in for dynamic gathers) over payloads
packed into exact bf16 columns (`Packer`); a GPU gathers directly, and every
function here is exact data movement for every dtype. `gather_rows` and
`scatter_rows` keep the contractions' interface (a one-hot, f32 out) and
their results: a one-hot row with no set entry gives a zero row.

Groups are class-outermost: g = s * W + w holds class s of world w, whose
slots are {i : i % NS == s} (SPEC D2b), `Asub = A / NS` of them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

bf16 = torch.bfloat16
f32 = torch.float32


def split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 `x` as three bf16 planes with h1 + h2 + h3 == x exactly (for |x|
    >= ~2^-133 or x == 0): each plane is the round-to-nearest-even bf16 of
    the remainder, as `lax.reduce_precision(x, 8, 7)` computes it."""
    x = x.to(f32)
    h1 = x.to(bf16)
    r1 = x - h1.to(f32)
    h2 = r1.to(bf16)
    h3 = (r1 - h2.to(f32)).to(bf16)
    return h1, h2, h3


class Packer:
    """Accumulates fields into one [..., C] bf16 payload, as the JAX
    `Packer`: `add_int` (integer-valued, |v| <= 256, one exact bf16
    column), `add_bf16` (cast to bf16 first), `add_f32` (the three exact
    `split3` planes); `payload()` concatenates them; `unpack(out)` cuts a
    gathered f32 [..., C] result back into the fields in f32 (an f32
    field's planes re-summed), [G, A] fields without a trailing axis."""

    def __init__(self):
        self._cols: List[torch.Tensor] = []
        self._specs: List[Tuple[str, int, bool]] = []     # kind, width, squeeze

    def _add(self, kind: str, x: torch.Tensor) -> int:
        squeeze = x.dim() == 2
        xd = x[..., None] if squeeze else x
        self._cols.append(torch.cat(split3(xd), dim=-1) if kind == "f32" else xd.to(bf16))
        self._specs.append((kind, xd.shape[-1], squeeze))
        return len(self._specs) - 1

    def add_int(self, x: torch.Tensor) -> int:
        return self._add("int", x)

    def add_bf16(self, x: torch.Tensor) -> int:
        return self._add("bf16", x)

    def add_f32(self, x: torch.Tensor) -> int:
        return self._add("f32", x)

    def payload(self) -> torch.Tensor:
        return torch.cat(self._cols, dim=-1)

    def unpack(self, out: torch.Tensor) -> List[torch.Tensor]:
        fields, c = [], 0
        for kind, w, squeeze in self._specs:
            if kind == "f32":
                x = out[..., c:c + w] + out[..., c + w:c + 2 * w] + out[..., c + 2 * w:c + 3 * w]
                c += 3 * w
            else:
                x = out[..., c:c + w]
                c += w
            fields.append(x[..., 0] if squeeze else x)
        if c != out.shape[-1]:
            raise ValueError(f"unpacked {c} columns of {out.shape[-1]}")
        return fields


def gather_rows(oh: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """[G, K, A] one-hot x [G, A, C] payload -> [G, K, C] f32: row k is the
    payload row its one-hot selects, zeros where it selects none (the JAX
    contraction's result, by an index gather)."""
    hot = oh != 0
    idx = hot.to(torch.int8).argmax(dim=-1)
    out = torch.take_along_dim(payload, idx[..., None], dim=1).to(f32)
    return torch.where(hot.any(dim=-1)[..., None], out, torch.zeros((), dtype=f32,
                                                                    device=out.device))


def scatter_rows(oh: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """[G, K, A] one-hot x [G, K, C] payload -> [G, A, C] f32, the
    transposed contraction: column a gets the payload row whose one-hot
    selects it, zeros where none does."""
    return gather_rows(oh.transpose(1, 2), payload)


def taa_gather(payload: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[G, Asub, C] payload x [G, rows] slot -> [G, rows, C]: row r is
    payload[g, slot[g, r]]; rows past the count carry slot 0's data (mask
    with `valid`). Any dtype."""
    return torch.take_along_dim(payload, slot.long()[:, :, None], dim=1)


def class_major(x: torch.Tensor, NS: int) -> torch.Tensor:
    """[W, A(, k)] -> class-outermost [G = NS * W, A / NS(, k)]: group s * W
    + w holds class s of world w, slot order kept."""
    W, A = x.shape[:2]
    x4 = x.reshape((W, A // NS, NS) + x.shape[2:])
    return x4.permute((2, 0, 1) + tuple(range(3, x4.dim()))).reshape(
        (NS * W, A // NS) + x.shape[2:])


def compact_slots(mask: torch.Tensor, rows: int):
    """Per-group rank compaction. mask [G, Asub] bool ->
      slot  [G, rows] i32 : slot index of the r-th set entry (ascending), 0
                            where r >= count (mask with `valid`)
      valid [G, rows] bool: r < count(g)
      keep  [G, Asub] bool: set entries of rank < rows (overflow dropped)
    """
    G, Asub = mask.shape
    rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (rank < rows)
    # Kept entries scatter their slot index to column `rank`; the rest go to
    # a spill column that is cut off (only it ever receives duplicates).
    col = torch.where(keep, rank, rows).long()
    slot = torch.zeros((G, rows + 1), dtype=torch.int32, device=mask.device)
    idx = torch.arange(Asub, dtype=torch.int32, device=mask.device).expand(G, Asub)
    slot.scatter_(1, col, idx)
    count = mask.sum(dim=1, dtype=torch.int32)
    valid = torch.arange(rows, device=mask.device)[None, :] < count[:, None]
    return slot[:, :rows].contiguous(), valid, keep


def compact_gather(payload: torch.Tensor, slot: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """[G, Asub, C] payload x [G, rows] slot -> [G, rows, C]: row r is
    payload[g, slot[g, r]] where valid, zeros elsewhere. Any dtype."""
    out = torch.take_along_dim(payload, slot.long()[:, :, None], dim=1)
    return torch.where(valid[:, :, None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))


def expand_scatter(src: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
                   Asub: int) -> torch.Tensor:
    """[G, rows, C] src -> [G, Asub, C]: dst[g, slot[g, r]] = src[g, r] for
    valid r, zeros at every slot no valid row maps to. Written as a gather
    through the inverse map (deterministic on every device)."""
    G, rows, C = src.shape
    col = torch.where(valid, slot, Asub).long()
    inv = torch.full((G, Asub + 1), -1, dtype=torch.int64, device=src.device)
    inv.scatter_(1, col, torch.arange(rows, device=src.device).expand(G, rows))
    inv = inv[:, :Asub]
    out = torch.take_along_dim(src, inv.clamp(min=0)[:, :, None], dim=1)
    return torch.where((inv >= 0)[:, :, None], out,
                       torch.zeros((), dtype=src.dtype, device=src.device))


def taa_scatter(src: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
                Asub: int) -> torch.Tensor:
    """[G, rows, C] src -> [G, Asub, C]: dst[g, slot[g, r]] = src[g, r] for
    valid r, zeros elsewhere; an empty group gives zeros (its invalid rows
    never reach slot 0). The JAX `taa_scatter`; here `expand_scatter`."""
    return expand_scatter(src, slot, valid, Asub)


def kslot_from_class_slots(slot: torch.Tensor, valid: torch.Tensor, W: int,
                           NS: int) -> torch.Tensor:
    """[G = NS*W, rows] class-local slots (class-outermost groups) -> [W, K =
    NS*rows] slots into the world's A slots, -1 at invalid rows; k = s * rows
    + r. Class s holds slots {i : i % NS == s}, so global = local * NS + s."""
    rows = slot.shape[1]
    spec = torch.arange(NS, dtype=slot.dtype, device=slot.device)[:, None, None]
    g3 = slot.reshape(NS, W, rows) * NS + spec
    g3 = torch.where(valid.reshape(NS, W, rows), g3, -1)
    return g3.permute(1, 0, 2).reshape(W, NS * rows).to(torch.int32).contiguous()
