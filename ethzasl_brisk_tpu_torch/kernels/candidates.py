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
in torch: the survivors (masked in and above the sentinel) as unique
keys, the whole list sorted where it fits ``key_capacity(k)`` keys, else
a radix select of the k-th key's score word (four 8-bit digits) and the
first ties at it in flat order; then the pixels at the sentinel, in flat
order, for the slots left; then, on float scores, the masked-in pixels
under -inf (a NaN with its sign set) by their keys, as the survivors.
``launch_plan`` puts a layer's key list in shared memory or, past
``CHUNK_KEYS`` keys, in a device-memory scratch.
"""
from __future__ import annotations

import ctypes

import torch

from ethzasl_brisk_tpu_torch import _kernels

INT32_MIN = -(2**31)
# csrc/candidates.cu: kMaxLayers layers a launch, kFields int64 fields a
# layer; a CTA sorts up to kChunkKeys keys in shared memory.
MAX_LAYERS = 8
FIELDS = 11
CHUNK_KEYS = 16384
ROUTES = ("shared", "device")
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


def key_capacity(k: int) -> int:
    """The keys a layer's list holds: k rounded up to a power of two (the
    bitonic network's length)."""
    return 1 << max(k - 1, 0).bit_length()


def layer_route(k: int) -> str:
    """Where kernel ``layer_candidates`` keeps a layer's key list: shared
    memory while ``key_capacity(k)`` keys fit a chunk, else device memory."""
    return "shared" if key_capacity(k) <= CHUNK_KEYS else "device"


def _order(sc: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving unsigned image of int32 or float32
    scores (of the IEEE total order on floats), as int64."""
    return _total_order(sc).to(torch.int64) - INT32_MIN


def _twin_tier(hi: torch.Tensor, tier: torch.Tensor, k: int, capacity: int) -> torch.Tensor:
    """The flat indices (int64) of the first k pixels of ``tier`` by their
    inverted score words ``hi``, ascending, ties to the lower index: the
    tier sorted whole where it fits ``capacity`` keys, else a radix select
    of the k-th key's score word and the first ties at it in flat order."""
    if int(tier.sum()) <= capacity:
        listed = tier.nonzero()[:, 0]
    else:
        # The k-th key's score word by four 8-bit digits, then the tier's
        # pixels above it and the first ties at it in flat order.
        word, left = 0, k
        for shift in (24, 16, 8, 0):
            high = 0 if shift == 24 else (_U32 << (shift + 8)) & _U32
            at = tier & ((hi & high) == word)
            hist = torch.bincount((hi[at] >> shift) & 0xFF, minlength=256).tolist()
            d = 0
            while hist[d] < left:
                left -= hist[d]
                d += 1
            word |= d << shift
        ties = (tier & (hi == word)).nonzero()[:left, 0]
        listed = torch.cat([(tier & (hi < word)).nonzero()[:, 0], ties]).sort().values
    return listed[torch.sort(hi[listed], stable=True).indices][:k]


def _twin_frame(sc: torch.Tensor, m: torch.Tensor, k: int):
    """One frame of the twin: the flat indices of the k slots (int64), and
    how many are survivors and how many sentinel fills after them."""
    low = _order(torch.full((1,), sentinel(sc.dtype), dtype=sc.dtype))[0]
    order = _order(sc)
    hi = _U32 - order  # the inverted score word: ascending is best first
    head = _twin_tier(hi, m & (order > low), k, key_capacity(k))
    fill = (~m | (order == low)).nonzero()[: k - len(head), 0]
    rest = k - len(head) - len(fill)
    # Float scores only: the masked-in pixels under -inf (a NaN with its
    # sign set), by their keys.
    tail = _twin_tier(hi, m & (order < low), rest, key_capacity(k))
    return torch.cat([head, fill, tail]), len(head), len(fill)


def layer_candidates_twin(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list):
    """The kernel's algorithm in torch, frame by frame; any device."""
    cands = []
    for sc, m, cap in zip(scores, masks, caps):
        bsz, h, w = sc.shape
        k = min(cap, h * w)
        out = tuple(torch.empty((bsz, k), dtype=t, device=sc.device)
                    for t in (torch.int32, torch.int32, sc.dtype, torch.bool))
        for f in range(bsz):
            idx, n_head, n_fill = _twin_frame(sc[f].reshape(-1), m[f].reshape(-1), k)
            top = sc[f].reshape(-1)[idx]
            top[n_head : n_head + n_fill] = sentinel(sc.dtype)
            for col, v in zip(out, (idx % w, idx // w, top, m[f].reshape(-1)[idx])):
                col[f] = v
        cands.append(out)
    return cands, mask_counts(masks)


def launch_plan(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list,
                routes: "list[str] | None" = None):
    """The launches of kernel ``layer_candidates`` on
    ``layer_candidates_cuda``'s arguments, checked: (candidate lists,
    counts, [(layer table, layer count), ...], scratch tensors). A layer's
    route is ``layer_route(k)`` unless ``routes`` names it ("shared" only
    where its keys fit a chunk). The tables are ctypes int64 arrays of
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
    cands, rows, keep = [], [], []
    counts = torch.empty((frames, n_layers), dtype=torch.int32, device=dev)
    for i, (sc, m, cap, route) in enumerate(zip(scores, masks, caps, routes)):
        if (sc.device != dev or sc.dtype != dtype or sc.dim() != 3 or sc.shape[0] != frames
                or not sc.is_contiguous()):
            raise ValueError(f"layer {i}: expected contiguous {dtype} ({frames}, h, w) on {dev}, "
                             f"got {sc.dtype} {tuple(sc.shape)} on {sc.device}")
        if m.device != dev or m.dtype != torch.bool or m.shape != sc.shape or not m.is_contiguous():
            raise ValueError(f"mask {i}: expected contiguous bool {tuple(sc.shape)} on {dev}")
        h, w = sc.shape[1:]
        if int(cap) < 0 or h * w >= 2**30:
            raise ValueError(f"layer {i}: cap {cap} on a {h} x {w} map")
        k = min(int(cap), h * w)
        route = route or layer_route(k)
        if route not in ROUTES or (route == "shared" and key_capacity(k) > CHUNK_KEYS):
            raise ValueError(f"layer {i}: route {route!r} for k = {k}")
        out = (torch.empty((frames, k), dtype=torch.int32, device=dev),
               torch.empty((frames, k), dtype=torch.int32, device=dev),
               torch.empty((frames, k), dtype=dtype, device=dev),
               torch.empty((frames, k), dtype=torch.bool, device=dev))
        scratch = (torch.empty((frames * key_capacity(k),), dtype=torch.int64, device=dev)
                   if route == "device" else None)
        cands.append(out)
        keep.append(scratch)
        rows.append([sc.data_ptr(), m.data_ptr(), *(t.data_ptr() for t in out),
                     0 if scratch is None else scratch.data_ptr(), h, w, k, i])
    chunks = [rows[j : j + MAX_LAYERS] for j in range(0, len(rows), MAX_LAYERS)]
    tables = [((ctypes.c_int64 * (len(c) * FIELDS))(*(v for r in c for v in r)), len(c))
              for c in chunks]
    return cands, counts, tables, keep


def layer_candidates_cuda(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list,
                          routes: "list[str] | None" = None):
    """Kernel ``layer_candidates``: every layer's list and the (B, L) mask
    counts in one launch (up to 8 layers a launch). ``scores``: contiguous
    int32 or float32 (B, h, w) CUDA tensors on one card, one B and one
    type; ``masks``: their bool masks; ``routes`` forces a layer's route
    (to time and check it)."""
    cands, counts, tables, _scratch = launch_plan(scores, masks, caps, routes)
    dev = scores[0].device
    is_float = int(scores[0].dtype == torch.float32)
    for table, n in tables:
        _kernels.launch("layer_candidates", "layer_candidates", dev, table, n,
                        scores[0].shape[0], len(scores), is_float, counts.data_ptr())
    return cands, counts


def layer_candidates(scores: list[torch.Tensor], masks: list[torch.Tensor], caps: list):
    """Every layer's candidate list and the (B, L) mask counts: kernel
    ``layer_candidates`` (one launch) for CUDA tensors,
    ``layer_candidates_plain`` for CPU tensors."""
    if all(sc.device.type == "cpu" for sc in scores):
        return layer_candidates_plain(scores, masks, caps)
    return layer_candidates_cuda([sc.contiguous() for sc in scores],
                                 [m.contiguous() for m in masks], caps)
