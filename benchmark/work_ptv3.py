"""Useful work of a Point Transformer V3 training step on a given batch,
counted from the plain reference's own voxel hash and patch maps
(`reference/ptv3.py`), never from the program's tables or launches.

- attention: 4 K 16 FLOP per padded row and head a block (q k^T and the
  weights times v, over the row's patch of K), padded rows counted as
  the patch maps lay them out; its backward 2.5 times that;
- Linears: 2 in out FLOP per row (qkv, proj, xCPE's Linear, the MLP's
  two, pooling's and unpooling's projections, the head);
- convs: 2 Cin Cout FLOP per tap that hits (27 taps in every block's
  xCPE, 125 in the stem).
A training step is three times the forward.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import ptv3 as R

PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
HEAD_DIM = 16


@dataclass
class Counts:
    rows: list      # valid rows per level
    padded: list    # attention rows per level (the patch maps' padding)
    patch: list     # K per level
    hits: list      # 27-tap hits per level
    stem_hits: int  # 125-tap hits of level 0


def counts(batch: dict) -> Counts:
    """The work's counts of one collated batch ('grid_coord', 'offset',
    'feat')."""
    with torch.no_grad():
        pyr = R.pyramid(batch["grid_coord"], batch["offset"], batch["feat"])
        padded, patch = [], []
        for c in pyr.counts:
            K = min(R.MAX_PATCH, min(c))
            patch.append(K)
            padded.append(sum(-(-n // K) * K for n in c))
        return Counts(rows=[l.size for l in pyr.levels], padded=padded,
                      patch=patch,
                      hits=[int((l.neighbours(1) >= 0).sum())
                            for l in pyr.levels],
                      stem_hits=int((pyr.levels[0].neighbours(2) >= 0)
                                    .sum()))


def _blocks(model: dict):
    """(level, width) of every block, encoder then decoder."""
    enc, dec = model["enc_channels"], model["dec_channels"]
    out = [(s, enc[s]) for s, d in enumerate(model["enc_depths"])
           for _ in range(d)]
    out += [(s, dec[s]) for s in reversed(range(len(dec)))
            for _ in range(model["dec_depths"][s])]
    return out


def attention_flops(c: Counts, model: dict) -> float:
    """Forward FLOPs of every block's attention."""
    return sum(4.0 * c.padded[l] * c.patch[l] * HEAD_DIM * (w // HEAD_DIM)
               for l, w in _blocks(model))


def model_flops(c: Counts, model: dict) -> float:
    """Forward FLOPs of the network: attention, Linears and convs."""
    enc, dec = model["enc_channels"], model["dec_channels"]
    f = attention_flops(c, model)
    for l, w in _blocks(model):
        f += 2.0 * c.rows[l] * 13 * w * w       # qkv, proj, cpe, MLP
        f += 2.0 * c.hits[l] * w * w            # xCPE's conv
    f += 2.0 * c.stem_hits * model["in_channels"] * enc[0]
    for s in range(1, len(enc)):                # pooling
        f += 2.0 * c.rows[s - 1] * enc[s - 1] * enc[s]
    up_in = list(dec) + [enc[-1]]
    for s in range(len(dec)):                   # unpooling
        f += 2.0 * c.rows[s + 1] * up_in[s + 1] * dec[s]
        f += 2.0 * c.rows[s] * enc[s] * dec[s]
    return f + 2.0 * c.rows[0] * dec[0] * model["num_classes"]
