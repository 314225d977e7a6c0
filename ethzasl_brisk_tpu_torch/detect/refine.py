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
``refine_keypoints_twin`` is the kernel's algorithm in torch: the flags
ranked in chunks of ``CHUNK`` with the ranks carried (``chunk_walk``:
runs of ``RUN`` flags a thread, one scan a chunk, a chunk that keeps no
slot skipped), the kept flags in a chunk's slot table and each entry's slot,
then every slot's own nine taps and ``subpixel2d``, which the kernel runs
op for op.
"""
from __future__ import annotations

import array
import ctypes
import struct

import torch

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.detect.subpixel import subpixel2d

# csrc/refine.cu: kMaxLayers layers a launch, kFields int64 fields a layer,
# kOuts output pointers; a CTA of kThreads threads ranks a chunk of
# kChunk flags (the slot table's entries), a run of RUN a thread; the count
# pass keeps the accepted counts of a row's first kMaxChunks chunks.
MAX_LAYERS = 8
FIELDS = 14
OUTS = 8
THREADS = 512
CHUNK = 16384
RUN = CHUNK // THREADS
MAX_CHUNKS = 128
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


def row_offsets(accept: torch.Tensor) -> torch.Tensor:
    """(B,) int64: the byte each (B, k) row's first flag holds in its
    16-byte word, as the kernel reads the rows."""
    bsz, k = accept.shape
    first = torch.arange(bsz, dtype=torch.int64, device=accept.device) * k
    return (first + accept.data_ptr()) % 16


def chunk_walk(accept: torch.Tensor, cap: int, offsets=None):
    """The kernel's compaction of (B, k) accept flags cut to ``cap`` < k:
    ``(src, ranked)``, src (B, cap) int64 the candidate of each slot, ranked
    (B, chunks) bool the chunks the walk ranks.

    Flag i sits at virtual position ``offsets[b] + i`` (the byte of its row
    in a 16-byte word, ``row_offsets`` by default); chunk c holds the
    positions [c * CHUNK, (c + 1) * CHUNK), thread t of its CTA of
    ``THREADS`` the run of ``RUN`` from t * RUN. The count pass gives
    each chunk's accepted count a_c and the row's n_acc; of cap slots,
    acc_slots = min(n_acc, cap) take the accepted, the rest_slots
    after them the others. A chunk with a0 accepted and r0 other flags
    before it keeps ka = clamp(acc_slots - a0, 0, a_c) accepted and kr of
    the others; one that keeps none is skipped (a row of one chunk is
    always ranked, and a chunk past the first MAX_CHUNKS is ranked until
    every slot is placed). A ranked chunk's scan of its runs' accepted
    counts ranks its flags; an accepted flag of rank r < acc_slots takes
    table entry r - a0, another of rank r < rest_slots entry ka + r - r0;
    entry e is fitted into slot a0 + e (e < ka) or n_acc + r0 + e - ka."""
    bsz, k = accept.shape
    dev = accept.device
    off = row_offsets(accept) if offsets is None else torch.as_tensor(offsets, device=dev)
    off = off.to(torch.int64).reshape(bsz)
    n_chunks = max(-(-(int(off.max()) + k) // CHUNK), 1)
    pos = off[:, None] + torch.arange(k, device=dev)
    flags = torch.zeros((bsz, n_chunks * CHUNK), dtype=torch.int64, device=dev)
    in_row = torch.zeros_like(flags)
    flags.scatter_(1, pos, accept.to(torch.int64))
    in_row.scatter_(1, pos, torch.ones_like(pos))
    flags = flags.view(bsz, n_chunks, THREADS, RUN)
    in_row = in_row.view(bsz, n_chunks, THREADS, RUN)
    # The count pass: each chunk's accepted flags, and its flags.
    a_c, f_c = flags.sum((2, 3)), in_row.sum((2, 3))
    n_acc = a_c.sum(1, keepdim=True)
    acc_slots = n_acc.clamp(max=cap)
    rest_slots = cap - acc_slots
    a0 = a_c.cumsum(1) - a_c
    r0 = f_c.cumsum(1) - f_c - a0
    ka = (acc_slots - a0).clamp(min=0).minimum(a_c)
    kr = (rest_slots - r0).clamp(min=0).minimum(f_c - a_c)
    chunk = torch.arange(n_chunks, device=dev)
    placed = (a0 >= acc_slots) & (r0 >= rest_slots)
    ranked = (ka + kr > 0) | ((chunk >= MAX_CHUNKS) & ~placed)
    if n_chunks == 1:
        ranked[:] = True
    # One block scan a chunk: each run's accepted flags before it, and
    # its first flag's position in the row.
    run_acc = flags.sum(3)
    t_acc = a0[..., None] + run_acc.cumsum(2) - run_acc
    start = chunk[:, None] * CHUNK + torch.arange(THREADS, device=dev) * RUN
    t_rest = (start - off[:, None, None]).clamp(min=0) - t_acc
    rest = in_row - flags
    rank_acc = t_acc[..., None] + flags.cumsum(3) - flags
    rank_rest = t_rest[..., None] + rest.cumsum(3) - rest
    keep_acc = (flags == 1) & (rank_acc < acc_slots[..., None, None])
    keep_rest = (rest == 1) & (rank_rest < rest_slots[..., None, None])
    keep = keep_acc | keep_rest  # none in a chunk the walk skips
    entry = torch.where(keep_acc, rank_acc - a0[..., None, None],
                        ka[..., None, None] + rank_rest - r0[..., None, None])
    # The slot tables: each kept flag's position in its chunk at its entry.
    table = torch.full((bsz, n_chunks, CHUNK), -1, dtype=torch.int64, device=dev)
    b_of = torch.arange(bsz, device=dev)[:, None, None, None].expand_as(keep)
    c_of = chunk[None, :, None, None].expand_as(keep)
    local = torch.arange(CHUNK, device=dev).view(THREADS, RUN).expand_as(keep)
    table[b_of[keep], c_of[keep], entry[keep]] = local[keep]
    # The fit, slot-major: entry e of a chunk into its slot.
    e = torch.arange(CHUNK, device=dev)
    used = e < (ka + kr)[..., None]
    slot = torch.where(e < ka[..., None], a0[..., None] + e,
                       n_acc[..., None] + r0[..., None] + e - ka[..., None])
    cand = chunk[:, None] * CHUNK + table - off[:, None, None]
    src = torch.full((bsz, cap), -1, dtype=torch.int64, device=dev)
    src[torch.arange(bsz, device=dev)[:, None, None].expand_as(used)[used], slot[used]] = cand[used]
    return src, ranked


def compaction_slots(accept: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap) int64: the candidate each slot takes, by the kernel's chunk
    walk (``chunk_walk``; slot j is candidate j where cap >= k)."""
    bsz, k = accept.shape
    if cap >= k:
        return torch.arange(k, device=accept.device).expand(bsz, k)
    return chunk_walk(accept, cap)[0]


def refine_keypoints_twin(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """The kernel's algorithm in torch (``compaction_slots``: the chunk
    walk and its slot tables; then each slot's taps and ``subpixel2d``),
    layer by layer; any device."""
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


def _int64_table(values: list):
    """A ctypes int64 array over an ``array.array`` of ``values``, which
    fills it at C speed (the ctypes constructor takes its values one
    argument at a time)."""
    return (ctypes.c_int64 * len(values)).from_buffer(array.array("q", values))


def launch_tables(rows: list, out_ptrs: list):
    """The C entry's tables: [(layer table, layer count), ...], up to
    ``MAX_LAYERS`` rows of ``FIELDS`` int64 a table, and the outputs'
    table of ``OUTS`` pointers."""
    tables = [(_int64_table([v for r in rows[j : j + MAX_LAYERS] for v in r]),
               len(rows[j : j + MAX_LAYERS])) for j in range(0, len(rows), MAX_LAYERS)]
    return tables, _int64_table(out_ptrs)


def layer_rows(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """``refine_keypoints_cuda``'s arguments checked, and each layer's row
    of the kernel's table: (rows, the packing's columns, the tensors the
    rows point at). The tensors the kernel reads are made contiguous here
    (``.contiguous()`` returns a contiguous tensor itself), so the rows
    point at the copies the caller keeps until the launch."""
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
    rows, keep, col = [], [], 0
    for i, (sc, (xs, ys, top, _), accept, cap, g) in enumerate(
            zip(scores, cands, accepts, caps, geoms)):
        if sc.device != dev or sc.dtype != dtype or sc.dim() != 3 or sc.shape[0] != frames:
            raise ValueError(f"layer {i}: expected {dtype} ({frames}, h, w) on {dev}, "
                             f"got {sc.dtype} {tuple(sc.shape)} on {sc.device}")
        k = xs.shape[1] if xs.dim() == 2 else -1
        cols = []
        for name, t, want in (("xs", xs, torch.int32), ("ys", ys, torch.int32),
                              ("scores", top, dtype), ("accept", accept, torch.bool)):
            if t.device != dev or t.dtype != want or t.shape != (frames, k):
                raise ValueError(f"layer {i} {name}: expected {want} ({frames}, k) on {dev}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            cols.append(t.contiguous())
        if not 0 <= int(cap) <= k:
            raise ValueError(f"layer {i}: cap {cap} outside [0, {k}]")
        sc = sc.contiguous()
        keep += [sc, *cols]
        rows.append([sc.data_ptr(), *(t.data_ptr() for t in cols), *sc.shape[1:], k, int(cap),
                     col, i, g.index // 2, _float_bits(g.scale), _float_bits(g.offset)])
        col += int(cap)
    return rows, col, keep


def launch_plan(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """The launches of kernel ``refine_keypoints`` on
    ``refine_keypoints_cuda``'s arguments, checked (``layer_rows``): (the
    KeyPoints fields, the counts, [(layer table, layer count), ...], the
    outputs' table, the tensors the tables point at). The layer tables are
    ctypes int64 arrays of ``FIELDS`` fields a layer, up to ``MAX_LAYERS``
    layers each."""
    rows, col, keep = layer_rows(scores, cands, accepts, caps, geoms, rdt)
    dev, frames = scores[0].device, scores[0].shape[0]
    fields = [torch.empty((frames, col), dtype=torch.float32, device=dev) for _ in range(5)]
    fields += [torch.empty((frames, col), dtype=torch.int32, device=dev),
               torch.empty((frames, col), dtype=torch.bool, device=dev)]
    counts = torch.empty((frames, len(rows)), dtype=torch.int32, device=dev)
    tables, outs = launch_tables(rows, [t.data_ptr() for t in (*fields, counts)])
    return KeyPoints(*fields), counts, tables, outs, keep


def refine_keypoints_cuda(scores, cands, accepts, caps, geoms, rdt=torch.float32):
    """Kernel ``refine_keypoints``: every layer's compaction, fit and
    packing, and the (B, L) accepted counts, in one launch (up to 8 layers
    a launch). ``scores``: int32 or float32 (B, h, w) CUDA tensors on one
    card; ``cands``, ``accepts``, ``caps``, ``geoms``: as
    ``refine_keypoints_plain`` (any strides: the kernel reads contiguous
    copies where they are not)."""
    kps, counts, tables, outs, _keep = launch_plan(scores, cands, accepts, caps, geoms, rdt)
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
    return refine_keypoints_cuda(scores, cands, accepts, caps, geoms, rdt)
