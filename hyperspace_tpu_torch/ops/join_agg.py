"""Fused join + aggregation: aggregate over an equi-join WITHOUT
materializing the joined pairs.

Every standard aggregate over the join decomposes over each primary row's
match RUN [st_i, en_i) in the sorted secondary side of its bucket:

    count(*)                += (en_i - st_i)                per primary row
    sum(primary expr v)     += v_i * (en_i - st_i)
    sum(secondary expr u)   += P[en_i] - P[st_i]            (P = prefix sum)
    min/max(primary v)      over the matched primary rows
    min/max(secondary u)    over the secondary's key run (all rows with
                            one key are one contiguous run of the sorted
                            side, and extrema do not depend on multiplicity)

so the aggregation needs only the run bounds plus a prefix sum, a gather
and one segment reduce, all on the device, and returns K per-group values
instead of the pairs.

A port of the JAX package's `ops/join_agg.py::fused_join_aggregate` and
its channel program (`_one_bucket` / `_combine_buckets`). The run bounds
always come from K2 (ops/sortkeys.py::run_bounds) on the card, at any
width: the JAX package's 8,192-row and 128-multiple gates have no
counterpart. The primary codes arrive sorted within each bucket row, so
each of K2's tiles of them searches only the window of secondary codes
it spans. Two things differ from the JAX program, neither in value:

- the secondary run extrema are one K1 reduction (ops/segment_reduce.py)
  over (bucket, key) run ids followed by a gather, where the JAX package
  takes a segmented prefix scan's value at each run end — the same exact
  min/max, NaN propagating;
- the fold over groups is ONE K1 launch over the flattened [B·Lp] rows,
  pads on the dead group `num_groups`, not a per-bucket [B, C, K]
  intermediate summed over buckets (at 200 buckets and 1.5M groups that
  intermediate would not fit). Exact channels come out bit-equal either
  way; non-integral sums add in another order.
"""

from __future__ import annotations

import torch

from hyperspace_tpu_torch.ops.join import sentinel_for
from hyperspace_tpu_torch.ops.segment_reduce import segment_reduce
from hyperspace_tpu_torch.ops.sortkeys import run_bounds

# Reduce kind of every channel kind in the group fold.
_FOLD = {"star": "sum", "p": "sum", "s": "sum", "pmin": "min", "smin": "min", "pmax": "max", "smax": "max"}


def _secondary_run_extrema(sk, svals, st, matched, ext_channels):
    """Per primary row, the extremum of each secondary channel over the
    row's key run: one K1 reduction of the channels over run ids (a run is
    a maximal stretch of one key inside one bucket row), then a gather at
    the run the row's bounds start in. Returns {channel index: [B, Lp]}
    with the ±inf identity where the row has no match."""
    b, ls = sk.shape
    out = {}
    if ls == 0:
        for c, kind, _ in ext_channels:
            ident = float("inf") if kind == "smin" else float("-inf")
            out[c] = torch.full(st.shape, ident, dtype=torch.float64, device=sk.device)
        return out
    new_run = torch.ones((b, ls), dtype=torch.bool, device=sk.device)
    new_run[:, 1:] = sk[:, 1:] != sk[:, :-1]
    run_id = torch.cumsum(new_run.reshape(-1), 0) - 1
    num_runs = int(run_id[-1]) + 1
    fns = tuple("min" if kind == "smin" else "max" for _, kind, _ in ext_channels)
    vals = torch.stack([svals[j].reshape(-1) for _, _, j in ext_channels])
    run_ext = segment_reduce(vals, run_id.to(torch.int32), num_runs, fns)
    # The run a matched row's bounds start in (clamped for unmatched rows,
    # whose value is replaced by the identity below).
    pos = torch.arange(b, device=sk.device)[:, None] * ls + st.long().clamp(max=ls - 1)
    row_run = run_id[pos]
    for e, (c, kind, _) in enumerate(ext_channels):
        ident = float("inf") if kind == "smin" else float("-inf")
        out[c] = torch.where(matched, run_ext[e][row_run], torch.full((), ident, dtype=torch.float64, device=sk.device))
    return out


def fused_join_aggregate(
    pk: torch.Tensor,
    sk: torch.Tensor,
    pvals: torch.Tensor,
    svals: torch.Tensor,
    gid: torch.Tensor,
    num_groups: int,
    channels: tuple,
) -> torch.Tensor:
    """pk/sk: [B, Lp]/[B, Ls] int32 codes sorted within each bucket row,
    pads at the int32 max. pvals [Ap, B, Lp] / svals [As, B, Ls]: float64
    per-row channel values (nulls and pads pre-zeroed for sum channels,
    pre-set to the ±inf identity for extremum channels). gid [B, Lp]:
    int32 group ids of the primary rows, pads at `num_groups`. channels:
    ('star',) | ('p'|'s', j) sum channels | ('pmin'|'pmax'|'smin'|'smax', j)
    extremum channels. Returns [len(channels), num_groups] float64 on the
    inputs' device."""
    b, lp = pk.shape
    dev = pk.device
    st, en = run_bounds(pk.contiguous(), sk.contiguous())
    real = pk < sentinel_for(pk.dtype)
    matched = real & (en > st)
    runlen = torch.where(real, en - st, torch.zeros_like(en)).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    ext_channels = [(c, ch[0], ch[1]) for c, ch in enumerate(channels) if ch[0] in ("smin", "smax")]
    run_ext = _secondary_run_extrema(sk, svals, st, matched, ext_channels) if ext_channels else {}
    prefix: dict[int, torch.Tensor] = {}
    rows = []
    for c, ch in enumerate(channels):
        kind = ch[0]
        if kind == "star":
            w = runlen
        elif kind == "p":
            w = pvals[ch[1]] * runlen
        elif kind == "s":
            j = ch[1]
            if j not in prefix:
                # Per-bucket prefix with a leading zero: P[b, i] = Σ_{t<i} v.
                prefix[j] = torch.cat(
                    [torch.zeros((b, 1), dtype=torch.float64, device=dev), torch.cumsum(svals[j], dim=1)], dim=1
                )
            p = prefix[j]
            w = torch.where(real, p.gather(1, en.long()) - p.gather(1, st.long()), zero)
        elif kind in ("pmin", "pmax"):
            ident = float("inf") if kind == "pmin" else float("-inf")
            w = torch.where(matched, pvals[ch[1]], torch.full((), ident, dtype=torch.float64, device=dev))
        elif kind in ("smin", "smax"):
            w = run_ext[c]
        else:
            raise ValueError(f"unknown channel kind {kind!r}")
        rows.append(w.reshape(-1))
    if not rows:
        return torch.zeros((0, num_groups), dtype=torch.float64, device=dev)
    fns = tuple(_FOLD[ch[0]] for ch in channels)
    folded = segment_reduce(torch.stack(rows), gid.reshape(-1).to(torch.int32).contiguous(), num_groups + 1, fns)
    return folded[:, :num_groups]
