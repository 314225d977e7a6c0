"""The score-ordered candidate lists of a Harris pyramid's layers.

Port of the JAX ``_layer_candidates`` (``detect/scale_space.py``:
``lax.top_k`` over the whole masked map) and of the certificate's
per-layer mask counts, which the JAX package leaves to XLA; on the card
kernel ``layer_candidates`` of ``csrc/candidates.cu``, every layer of a
detection in one launch. Per (frame, layer), with k = min(cap, h*w), the
list is the first k pixels of the whole map by score, descending, a
masked-out pixel reading the sentinel (INT32_MIN, or -inf on the 16-bit
path's float scores) and ties going to the lower flat index: (xs, ys,
scores, valid), each (B, k), valid the mask's bit; and the mask's count.
Float scores order as ``lax.top_k`` orders them: by the IEEE total order
of their bits (+0.0 above -0.0; ``torch.sort`` would tie them), so a
masked-in NaN with its sign set comes after every pixel at -inf and keeps
its own score.

``layer_candidates`` is what the detector calls: one kernel launch for
CUDA tensors (or it raises), the plain version for CPU tensors.
``layer_candidates_plain`` is the stable full-map sort, layer by layer
(``top_candidates``); ``layer_candidates_twin`` is the kernel's algorithm
in torch: the map cut into ``cluster`` slices of its mask groups; the
survivors (masked in and above the sentinel) listed in flat order, all of
them where they fit the k slots, else a radix select over the slices of
the k-th word (four 8-bit digits) and the first ties at it in flat order;
the list sorted by four stable 8-bit LSD passes on the inverted score
word, a pass skipped where one digit holds every key; then the pixels at
the sentinel, in flat order, for the slots left; then, on float scores,
the masked-in pixels under -inf (a NaN with its sign set), as the
survivors. ``launch_plan`` (``cluster_size``, ``layer_route``) picks the
launch's cluster of CTAs a list and puts a layer's keys in the cluster's
shared memory or, past ``PART_KEYS`` keys a CTA, in a device-memory
scratch.
"""
from __future__ import annotations

import ctypes

import torch

from ethzasl_brisk_tpu_torch import _kernels

INT32_MIN = -(2**31)
# csrc/candidates.cu: kMaxLayers layers a launch, kFields int64 fields a
# layer, kThreads a CTA, a CTA's share of a list in shared memory up to
# kPartKeys keys, its two buffers up to kBufferKeys together, behind its
# kSharedBytes of tables, up to kMaxCluster CTAs a list.
MAX_LAYERS = 8
FIELDS = 11
THREADS = 512
PART_KEYS = 5632
BUFFER_KEYS = 11264
SHARED_BYTES = 18432
MAX_CLUSTER = 16
CLUSTERS = (1, 2, 4, 8, 16)
ROUTES = ("shared", "device")
# The plan: clusters of 8 while the launch's CTAs stay within CLUSTER_CTAS
# (halved past it: about one wave of two CTAs an SM), 16 (a non-portable
# cluster) for at most two lists with a map of LARGE_MAP pixels or more (a
# VGA layer a detection).
CLUSTER_CTAS = 256
LARGE_MAP = 2**17
_U32 = 0xFFFFFFFF


def sentinel(dtype: torch.dtype) -> float:
    """What a masked-out pixel reads: -inf on float scores, else INT32_MIN."""
    return float("-inf") if dtype.is_floating_point else INT32_MIN


def _total_order(v: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is ``lax.top_k``'s: the values of int32
    scores, the IEEE total order of float32 ones."""
    if not v.dtype.is_floating_point:
        return v
    bits = v.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_candidates(sc: torch.Tensor, mask: torch.Tensor, cap: int):
    """Plain version of one layer: (xs, ys, scores, valid), each (B, k),
    by a stable descending sort of the masked (B, h, w) map."""
    bsz, h, w = sc.shape
    k = min(cap, h * w)
    masked = torch.where(mask, sc, torch.full_like(sc, sentinel(sc.dtype))).reshape(bsz, -1)
    top_idx = torch.sort(_total_order(masked), dim=1, descending=True, stable=True).indices[:, :k]
    top_scores = torch.gather(masked, 1, top_idx)
    ys = torch.div(top_idx, w, rounding_mode="floor").to(torch.int32)
    xs = (top_idx % w).to(torch.int32)
    valid = torch.gather(mask.reshape(bsz, -1), 1, top_idx)
    return xs, ys, top_scores, valid


def mask_counts(masks: list[torch.Tensor]) -> torch.Tensor:
    """(B, L) int32: the candidate mask's count of every frame and layer."""
    return torch.stack([m.sum(dim=(1, 2), dtype=torch.int32) for m in masks], dim=1)


def layer_candidates_plain(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list):
    """Plain version: ``top_candidates`` of every layer, and ``mask_counts``."""
    return [top_candidates(sc, m, cap) for sc, m, cap in zip(scores, masks, caps)], \
        mask_counts(masks)


def cluster_size(frames: int, n_layers: int, largest: int) -> int:
    """The CTAs a list of kernel ``layer_candidates``, one for the launch:
    16 for at most two lists with a map of ``LARGE_MAP`` pixels or more,
    else 8, halved while the launch's CTAs pass ``CLUSTER_CTAS`` (B x
    layers already fill the SMs)."""
    lists = frames * n_layers
    if lists <= 2 and largest >= LARGE_MAP:
        return MAX_CLUSTER
    c = 8
    while c > 1 and lists * c > CLUSTER_CTAS:
        c //= 2
    return c


def layer_route(k: int, cluster: int) -> str:
    """Where kernel ``layer_candidates`` keeps a layer's keys: the cluster's
    shared memory while a CTA's share, ceil(k / cluster), fits
    ``PART_KEYS``, else device memory."""
    return "shared" if -(-k // cluster) <= PART_KEYS else "device"


def shared_bytes(ks: list, cluster: int) -> int:
    """A CTA's dynamic shared memory for a launch whose shared-route layers
    list ``ks`` keys: its tables, a buffer of a CTA's share of the largest
    list and one half as large again, which first stages the CTA's slice's
    survivors, within ``BUFFER_KEYS`` keys for both (csrc/candidates.cu's
    host entry)."""
    part = max([-(-k // cluster) for k in ks] or [0])
    stage = max([min(p + p // 2, k, BUFFER_KEYS - p) for k in ks for p in [-(-k // cluster)]]
                or [0])
    return SHARED_BYTES + 8 * (part + max(part, stage))


def _order(sc: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving unsigned image of int32 or float32
    scores (of the IEEE total order on floats), as int64."""
    return _total_order(sc).to(torch.int64) - INT32_MIN


def _slices(n: int, offset: int, cluster: int) -> list[tuple[int, int]]:
    """The kernel's slices of a plane of n pixels whose mask starts
    ``offset`` bytes past a 16-byte boundary: the groups (the unaligned
    head and the tail a pixel, 16 pixels between) cut evenly over the
    cluster, as (first pixel, end) a CTA."""
    head = min((16 - offset % 16) % 16, n)
    vecs = (n - head) // 16
    tail = head + 16 * vecs
    total = head + vecs + (n - tail)

    def first(g):
        if g >= total:
            return n
        if g < head:
            return g
        return head + 16 * (g - head) if g < head + vecs else tail + (g - head - vecs)

    return [(first(total * r // cluster), first(total * (r + 1) // cluster))
            for r in range(cluster)]


def _twin_tier(hi: torch.Tensor, tier: torch.Tensor, limit: int, slices) -> tuple:
    """The flat indices (int64) of the first ``limit`` pixels of ``tier`` by
    their inverted score words ``hi``, ties in flat order, as the kernel
    finds them, and the bits of its radix passes run (0-3) and skipped
    (4-7): the tier listed in flat order, slice by slice (where more than
    ``limit`` are in it, after a radix select over the slices of the
    limit-th word and the first ties at it in flat order over the
    cluster), then four stable 8-bit LSD passes on the words, a pass
    skipped where one digit holds every key."""
    total = int(tier.sum())
    listed = min(total, limit)
    if listed <= 0:
        return hi.new_zeros(0), 0
    parts = [tier[a:b].nonzero()[:, 0] + a for a, b in slices]
    if total > limit:
        cut, left = 0, limit
        above = [0] * len(parts)
        for shift in (24, 16, 8, 0):
            high = 0 if shift == 24 else (_U32 << (shift + 8)) & _U32
            own = [torch.bincount((hi[p][(hi[p] & high) == cut] >> shift) & 0xFF,
                                  minlength=256) for p in parts]
            tot = torch.stack(own).sum(dim=0).tolist()
            d = 0
            while tot[d] < left:
                left -= tot[d]
                d += 1
            above = [a + int(o[:d].sum()) for a, o in zip(above, own)]
            ties = [int(o[d]) for o in own]
            cut |= d << shift
        taken, ties_before = [], 0
        for p, t in zip(parts, ties):
            take = min(max(left - ties_before, 0), t)
            ties_before += t
            w = hi[p]
            at = (w == cut).nonzero()[:take, 0]
            keep = (w < cut)
            keep[at] = True
            taken.append(p[keep])
        parts = taken
    keys = torch.cat(parts)
    words = hi[keys]
    ran = 0
    for p in range(4):
        digit = (words >> (8 * p)) & 0xFF
        if int(torch.bincount(digit, minlength=256).max()) == listed:
            ran |= 1 << (4 + p)
            continue
        ran |= 1 << p
        order = torch.sort(digit, stable=True).indices
        keys, words = keys[order], words[order]
    return keys, ran


def _twin_frame(sc: torch.Tensor, m: torch.Tensor, k: int, slices):
    """One frame of the twin: the flat indices of the k slots (int64), how
    many are survivors and how many sentinel fills after them, and the
    survivors' pass bits."""
    low = _order(torch.full((1,), sentinel(sc.dtype), dtype=sc.dtype))[0]
    order = _order(sc)
    hi = _U32 - order  # the inverted score word: ascending is best first
    surv, under = m & (order > low), m & (order < low)
    head, ran = _twin_tier(hi, surv, k, slices)
    # The fills: each slice's pixels at the sentinel from its offset among
    # the cluster's, in flat order.
    fills = torch.cat([(~(surv | under)[a:b]).nonzero()[:, 0] + a for a, b in slices])
    fill = fills[: k - len(head)]
    tail, _ = _twin_tier(hi, under, k - len(head) - len(fill), slices)
    return torch.cat([head, fill, tail]), len(head), len(fill), ran


def layer_candidates_twin(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list,
                          cluster: "int | None" = None, passes: "list | None" = None):
    """The kernel's algorithm in torch, frame by frame, with the launch's
    ``cluster`` (the plan's by default); any device. ``passes``, a list,
    gets each layer's (B,) survivor pass bits."""
    if cluster is None:
        cluster = cluster_size(scores[0].shape[0], len(scores),
                               max(sc[0].numel() for sc in scores))
    cands = []
    for sc, m, cap in zip(scores, masks, caps):
        bsz, h, w = sc.shape
        k = min(cap, h * w)
        out = tuple(torch.empty((bsz, k), dtype=t, device=sc.device)
                    for t in (torch.int32, torch.int32, sc.dtype, torch.bool))
        bits = []
        for f in range(bsz):
            mf = m[f].reshape(-1)
            slices = _slices(h * w, mf.data_ptr() % 16, cluster)
            idx, n_head, n_fill, ran = _twin_frame(sc[f].reshape(-1), mf, k, slices)
            top = sc[f].reshape(-1)[idx]
            top[n_head : n_head + n_fill] = sentinel(sc.dtype)
            for col, v in zip(out, (idx % w, idx // w, top, mf[idx])):
                col[f] = v
            bits.append(ran if k else 0)
        cands.append(out)
        if passes is not None:
            passes.append(torch.tensor(bits, dtype=torch.int32))
    return cands, mask_counts(masks)


def launch_plan(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list,
                routes: "list[str] | None" = None, cluster: "int | None" = None):
    """The launches of kernel ``layer_candidates`` on
    ``layer_candidates_cuda``'s arguments, checked: (candidate lists,
    counts, [(layer table, layer count), ...], scratch tensors, (cluster,
    routes)). The cluster is ``cluster_size`` of the launch unless
    ``cluster`` names it (one of ``CLUSTERS``); a layer's route is
    ``layer_route(k, cluster)`` unless ``routes`` names it ("shared" only
    where a CTA's share fits). The tables are ctypes int64 arrays of
    ``FIELDS`` fields a layer, up to ``MAX_LAYERS`` layers each."""
    n_layers = len(scores)
    routes = [None] * n_layers if routes is None else list(routes)
    if not (len(masks) == len(caps) == len(routes) == n_layers) or n_layers == 0:
        raise ValueError(f"layer_candidates_cuda: {n_layers} layers, {len(masks)} masks, "
                         f"{len(caps)} caps, {len(routes)} routes")
    dev = scores[0].device
    if dev.type != "cuda":
        raise ValueError(f"layer_candidates_cuda needs CUDA tensors, got {dev}")
    dtype, frames = scores[0].dtype, scores[0].shape[0]
    if dtype not in (torch.int32, torch.float32):
        raise ValueError(f"layer_candidates_cuda takes int32 or float32 scores, got {dtype}")
    for i, (sc, m, cap) in enumerate(zip(scores, masks, caps)):
        if (sc.device != dev or sc.dtype != dtype or sc.dim() != 3 or sc.shape[0] != frames
                or not sc.is_contiguous()):
            raise ValueError(f"layer {i}: expected contiguous {dtype} ({frames}, h, w) on {dev}, "
                             f"got {sc.dtype} {tuple(sc.shape)} on {sc.device}")
        if m.device != dev or m.dtype != torch.bool or m.shape != sc.shape or not m.is_contiguous():
            raise ValueError(f"mask {i}: expected contiguous bool {tuple(sc.shape)} on {dev}")
        if int(cap) < 0 or sc.shape[1] * sc.shape[2] >= 2**30:
            raise ValueError(f"layer {i}: cap {cap} on a {tuple(sc.shape[1:])} map")
    if cluster is None:
        cluster = cluster_size(frames, n_layers, max(sc.shape[1] * sc.shape[2] for sc in scores))
    if cluster not in CLUSTERS:
        raise ValueError(f"layer_candidates_cuda: cluster {cluster} not in {CLUSTERS}")
    cands, rows, keep, used = [], [], [], []
    counts = torch.empty((frames, n_layers), dtype=torch.int32, device=dev)
    for i, (sc, m, cap, route) in enumerate(zip(scores, masks, caps, routes)):
        h, w = sc.shape[1:]
        k = min(int(cap), h * w)
        route = route or layer_route(k, cluster)
        if route not in ROUTES or (route == "shared" and layer_route(k, cluster) != "shared"):
            raise ValueError(f"layer {i}: route {route!r} for k = {k} over {cluster} CTAs")
        out = (torch.empty((frames, k), dtype=torch.int32, device=dev),
               torch.empty((frames, k), dtype=torch.int32, device=dev),
               torch.empty((frames, k), dtype=dtype, device=dev),
               torch.empty((frames, k), dtype=torch.bool, device=dev))
        scratch = (torch.empty((frames, 2, k), dtype=torch.int64, device=dev)
                   if route == "device" else None)
        cands.append(out)
        keep.append(scratch)
        used.append(route)
        rows.append([sc.data_ptr(), m.data_ptr(), *(t.data_ptr() for t in out),
                     0 if scratch is None else scratch.data_ptr(), h, w, k, i])
    chunks = [rows[j : j + MAX_LAYERS] for j in range(0, len(rows), MAX_LAYERS)]
    tables = [((ctypes.c_int64 * (len(c) * FIELDS))(*(v for r in c for v in r)), len(c))
              for c in chunks]
    return cands, counts, tables, keep, (cluster, used)


def layer_candidates_cuda(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list,
                          routes: "list[str] | None" = None, cluster: "int | None" = None,
                          passes: "torch.Tensor | None" = None):
    """Kernel ``layer_candidates``: every layer's list and the (B, L) mask
    counts in one launch (up to 8 layers a launch). ``scores``: contiguous
    int32 or float32 (B, h, w) CUDA tensors on one card, one B and one
    type; ``masks``: their bool masks; ``routes`` and ``cluster`` force a
    layer's route and the CTAs a list (to time and check them);
    ``passes``, an int32 (B, L) tensor on the card, gets each list's
    survivor radix passes run (bits 0-3) and skipped (bits 4-7)."""
    cands, counts, tables, _scratch, (c, _) = launch_plan(scores, masks, caps, routes, cluster)
    dev = scores[0].device
    is_float = int(scores[0].dtype == torch.float32)
    if passes is not None and (passes.device != dev or passes.dtype != torch.int32
                               or passes.shape != counts.shape or not passes.is_contiguous()):
        raise ValueError(f"passes: expected contiguous int32 {tuple(counts.shape)} on {dev}")
    for table, n in tables:
        _kernels.launch("layer_candidates", "layer_candidates", dev, table, n,
                        scores[0].shape[0], len(scores), is_float, c, counts.data_ptr(),
                        0 if passes is None else passes.data_ptr())
    return cands, counts


def layer_candidates(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list):
    """Every layer's candidate list and the (B, L) mask counts: kernel
    ``layer_candidates`` (one launch) for CUDA tensors,
    ``layer_candidates_plain`` for CPU tensors."""
    if all(sc.device.type == "cpu" for sc in scores):
        return layer_candidates_plain(scores, masks, caps)
    return layer_candidates_cuda([sc.contiguous() for sc in scores],
                                 [m.contiguous() for m in masks], caps)
