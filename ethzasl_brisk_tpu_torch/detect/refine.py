"""The refine of a Harris detection: the accepted-prefix compaction, the
3x3 score taps, the sub-pixel fit, the un-mapping and the packing.

Port of the JAX ``compact_accepted`` and ``_refine_keypoints_fused``
(``detect/scale_space.py``) with ``subpixel2d`` (``detect/subpixel.py``),
and of the certificate's accepted counts, which the JAX package leaves to
XLA; on the card kernel ``refine_keypoints`` of ``csrc/refine.cu``, every
layer of a detection in one launch. Per (frame, layer) of k score-ordered
candidates (xs, ys, scores) and their accept flags, with ``cap`` =
min(k, max_num_kpt, the refine cap) from the caller:

* the compaction is the stable partition, accepted first, each part in
  its order, cut to cap (none when cap == k);
* slot j takes its 3x3 score patch, clamped at the border, in the refine
  type (float32, or float64 with ``refine_dtype="float64"``), runs the
  sub-pixel fit and the un-mapping ``x = scale*((x+dx)+offset)``, rounded
  once to float32;
* the slots of every layer pack layer-major into (B, C) ``KeyPoints``, C
  the sum of the caps (size scale*12, angle -1, response the score,
  octave, valid the accept flag); the accepted counts are (B, L) int32.

``refine_keypoints`` is what the detector calls: one kernel launch for
CUDA tensors (or it raises), the plain version for CPU tensors.
``refine_keypoints_plain`` is the torch chain (a sort a layer for the
compaction, nine gathers, ``subpixel2d`` over every layer's patches);
``refine_keypoints_twin`` is the kernel's algorithm in torch: each slot's
candidate by the ranks of the accepted and the rest, its own nine taps,
and ``subpixel2d``, which the kernel runs op for op.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.detect.subpixel import subpixel2d

# csrc/refine.cu: kMaxLayers layers a launch, kFields int64 fields a layer,
# kOuts output pointers.
MAX_LAYERS = 8
FIELDS = 14
OUTS = 8
REFINE_DTYPES = (torch.float32, torch.float64)


def compact_accepted(xs, ys, top_scores, valid, accept, cap: int):
    """The (B, k) columns compacted to their accepted prefix, cut to
    ``cap`` <= k, keeping the score order (a stable partition); as they
    are when cap == k."""
    cols = (xs, ys, top_scores, valid, accept)
    if cap < xs.shape[1]:
        order = torch.sort((~accept).to(torch.uint8), dim=1, stable=True).indices[:, :cap]
        cols = tuple(torch.gather(c, 1, order) for c in cols)
    return cols


def score_patches(sc: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B, C, 3, 3) patches, patch[a, b] = Score(x+b-1, y+a-1), clipped at
    the border (scale-space-layer-inl.h:394-402)."""
    bsz, h, w = sc.shape
    flat = sc.reshape(bsz, -1)
    rows = []
    for dy in (-1, 0, 1):
        yy = torch.clamp(ys + dy, 0, h - 1).to(torch.int64)
        taps = [
            torch.gather(flat, 1, yy * w + torch.clamp(xs + dx, 0, w - 1))
            for dx in (-1, 0, 1)
        ]
        rows.append(torch.stack(taps, dim=-1))
    return torch.stack(rows, dim=-2)


def refine_fused(scores, compacted, geoms, rdt=torch.float32) -> KeyPoints:
    """Sub-pixel refine + packing of every layer's compacted columns in one
    pass: one subpixel fit over all layers' slots, packed layer-major (the
    JAX package's fused and per-layer tails give this same output). The
    fit and the un-mapping run in ``rdt``; x and y round once to float32."""
    patches, cols = [], []
    for sc, (xs, ys, top_scores, _, accept), g in zip(scores, compacted, geoms):
        patches.append(score_patches(sc, xs, ys))
        ones = torch.ones(xs.shape, dtype=torch.float32, device=xs.device)
        cols.append(dict(
            x=xs, y=ys, scale=ones * g.scale, offset=ones * g.offset,
            size=ones * (g.scale * 12.0), octave=torch.full_like(xs, g.index // 2),
            response=top_scores.to(torch.float32), valid=accept,
        ))
    cat = {name: torch.cat([c[name] for c in cols], dim=1) for name in cols[0]}
    delta_x, delta_y, _ = subpixel2d(torch.cat(patches, dim=1).to(rdt))
    # KeyPointX = _scale * ((x + delta_x) + _offset) (scale-space-layer-inl.h:405);
    # the scales and offsets are exact in float32.
    scale, offset = cat["scale"].to(rdt), cat["offset"].to(rdt)
    fx = (scale * ((cat["x"].to(rdt) + delta_x) + offset)).to(torch.float32)
    fy = (scale * ((cat["y"].to(rdt) + delta_y) + offset)).to(torch.float32)
    return KeyPoints(
        x=fx,
        y=fy,
        size=cat["size"],
        angle=torch.full_like(fx, -1.0),
        response=cat["response"],
        octave=cat["octave"],
        valid=cat["valid"],
    )


def accepted_counts(accepts: list[torch.Tensor]) -> torch.Tensor:
    """(B, L) int32: the accepted candidates of every frame and layer."""
    return torch.stack([a.sum(dim=1, dtype=torch.int32) for a in accepts], dim=1)


def refine_keypoints_plain(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """Plain version: ``compact_accepted`` of every layer, ``refine_fused``
    and ``accepted_counts``. ``cands``: each layer's (xs, ys, scores,
    valid), (B, k) each; ``accepts``: (B, k) bool; ``caps``: each layer's
    cap (<= k); ``geoms``: each layer's ``scale``, ``offset`` and ``index``."""
    compacted = [compact_accepted(*c, a, cap) for c, a, cap in zip(cands, accepts, caps)]
    return refine_fused(scores, compacted, geoms, rdt), accepted_counts(accepts)


def compaction_slots(accept: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap) int64: the candidate each slot takes, by the kernel's ranks
    (an accepted candidate's rank among the accepted; the others after all
    the accepted, by their rank among the rest)."""
    bsz, k = accept.shape
    index = torch.arange(k, device=accept.device).expand(bsz, k)
    if cap >= k:
        return index
    acc = accept.to(torch.int64)
    slot = torch.where(accept, acc.cumsum(1) - 1,
                       acc.sum(1, keepdim=True) + (1 - acc).cumsum(1) - 1)
    keep = slot < cap
    src = torch.empty((bsz, cap), dtype=torch.int64, device=accept.device)
    frame = torch.arange(bsz, device=accept.device)[:, None].expand(bsz, k)
    src[frame[keep], slot[keep]] = index[keep]
    return src


def refine_keypoints_twin(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """The kernel's algorithm in torch (``compaction_slots``, each slot's
    taps, ``subpixel2d``), layer by layer; any device."""
    parts = []
    for sc, (xs, ys, top, _), accept, cap, g in zip(scores, cands, accepts, caps, geoms):
        bsz, h, w = sc.shape
        src = compaction_slots(accept, cap)
        cx, cy = torch.gather(xs, 1, src), torch.gather(ys, 1, src)
        flat = sc.reshape(bsz, -1)
        taps = [torch.gather(flat, 1, (torch.clamp(cy + a, 0, h - 1) * w
                                       + torch.clamp(cx + b, 0, w - 1)).to(torch.int64))
                for a in (-1, 0, 1) for b in (-1, 0, 1)]
        dx, dy, _ = subpixel2d(torch.stack(taps, dim=-1).to(rdt).unflatten(-1, (3, 3)))
        scale = torch.full((), g.scale, dtype=rdt, device=sc.device)
        offset = torch.full((), g.offset, dtype=rdt, device=sc.device)
        fx = (scale * ((cx.to(rdt) + dx) + offset)).to(torch.float32)
        parts.append(KeyPoints(
            x=fx,
            y=(scale * ((cy.to(rdt) + dy) + offset)).to(torch.float32),
            size=torch.full_like(fx, g.scale * 12.0),
            angle=torch.full_like(fx, -1.0),
            response=torch.gather(top, 1, src).to(torch.float32),
            octave=torch.full_like(cx, g.index // 2),
            valid=torch.gather(accept, 1, src),
        ))
    kps = KeyPoints(*(torch.cat(f, dim=1) for f in zip(*(p.fields() for p in parts))))
    return kps, accepted_counts(accepts)


def _float_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


def launch_plan(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """The launches of kernel ``refine_keypoints`` on
    ``refine_keypoints_cuda``'s arguments, checked: (the KeyPoints fields,
    the counts, [(layer table, layer count), ...], the outputs' table).
    The layer tables are ctypes int64 arrays of ``FIELDS`` fields a layer,
    up to ``MAX_LAYERS`` layers each."""
    n_layers = len(scores)
    if not (len(cands) == len(accepts) == len(caps) == len(geoms) == n_layers) or not n_layers:
        raise ValueError(f"refine_keypoints_cuda: {n_layers} layers, {len(cands)} candidate "
                         f"lists, {len(accepts)} accepts, {len(caps)} caps, "
                         f"{len(geoms)} geometries")
    dev = scores[0].device
    if dev.type != "cuda":
        raise ValueError(f"refine_keypoints_cuda needs CUDA tensors, got {dev}")
    if rdt not in REFINE_DTYPES:
        raise ValueError(f"refine_keypoints_cuda refines in float32 or float64, not {rdt}")
    dtype, frames = scores[0].dtype, scores[0].shape[0]
    if dtype not in (torch.int32, torch.float32):
        raise ValueError(f"refine_keypoints_cuda takes int32 or float32 scores, got {dtype}")
    rows, col = [], 0
    for i, (sc, (xs, ys, top, _), accept, cap, g) in enumerate(
            zip(scores, cands, accepts, caps, geoms)):
        if (sc.device != dev or sc.dtype != dtype or sc.dim() != 3 or sc.shape[0] != frames
                or not sc.is_contiguous()):
            raise ValueError(f"layer {i}: expected contiguous {dtype} ({frames}, h, w) on {dev}, "
                             f"got {sc.dtype} {tuple(sc.shape)} on {sc.device}")
        k = xs.shape[1] if xs.dim() == 2 else -1
        for name, t, want in (("xs", xs, torch.int32), ("ys", ys, torch.int32),
                              ("scores", top, dtype), ("accept", accept, torch.bool)):
            if (t.device != dev or t.dtype != want or tuple(t.shape) != (frames, k)
                    or not t.is_contiguous()):
                raise ValueError(f"layer {i} {name}: expected contiguous {want} ({frames}, k) "
                                 f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not 0 <= int(cap) <= k:
            raise ValueError(f"layer {i}: cap {cap} outside [0, {k}]")
        h, w = sc.shape[1:]
        rows.append([sc.data_ptr(), xs.data_ptr(), ys.data_ptr(), top.data_ptr(),
                     accept.data_ptr(), h, w, k, int(cap), col, i, g.index // 2,
                     _float_bits(g.scale), _float_bits(g.offset)])
        col += int(cap)
    fields = [torch.empty((frames, col), dtype=torch.float32, device=dev) for _ in range(5)]
    fields += [torch.empty((frames, col), dtype=torch.int32, device=dev),
               torch.empty((frames, col), dtype=torch.bool, device=dev)]
    counts = torch.empty((frames, n_layers), dtype=torch.int32, device=dev)
    outs = (ctypes.c_int64 * OUTS)(*(t.data_ptr() for t in (*fields, counts)))
    chunks = [rows[j : j + MAX_LAYERS] for j in range(0, len(rows), MAX_LAYERS)]
    tables = [((ctypes.c_int64 * (len(c) * FIELDS))(*(v for r in c for v in r)), len(c))
              for c in chunks]
    return KeyPoints(*fields), counts, tables, outs


def refine_keypoints_cuda(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """Kernel ``refine_keypoints``: every layer's compaction, fit and
    packing, and the (B, L) accepted counts, in one launch (up to 8 layers
    a launch). ``scores``: contiguous int32 or float32 (B, h, w) CUDA
    tensors on one card; ``cands``, ``accepts``, ``caps``, ``geoms``: as
    ``refine_keypoints_plain``."""
    kps, counts, tables, outs = launch_plan(scores, cands, accepts, caps, geoms, rdt)
    dev = scores[0].device
    is_float = int(scores[0].dtype == torch.float32)
    for table, n in tables:
        _kernels.launch("refine_keypoints", "refine_keypoints", dev, table, n, outs,
                        scores[0].shape[0], kps.capacity, len(scores), is_float,
                        int(rdt == torch.float64))
    return kps, counts


def refine_keypoints(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """The packed KeyPoints of a detection and its (B, L) accepted counts:
    kernel ``refine_keypoints`` (one launch) for CUDA tensors,
    ``refine_keypoints_plain`` for CPU tensors."""
    if all(sc.device.type == "cpu" for sc in scores):
        return refine_keypoints_plain(scores, cands, accepts, caps, geoms, rdt)
    return refine_keypoints_cuda(
        [sc.contiguous() for sc in scores],
        [tuple(t.contiguous() for t in c) for c in cands],
        [a.contiguous() for a in accepts], caps, geoms, rdt)
