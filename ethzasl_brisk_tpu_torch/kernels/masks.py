"""The integer candidate masks of a Harris pyramid: 2-D maxima, then the
3-D checks against the neighbour layers.

Port of the integer half of the JAX ``layer_score_masks``
(``detect/scale_space.py``: ``maxima2d_mask``, ``warp_scores_split``,
``_max3x3_pair`` and ``center_ge_warped``), which the JAX package leaves to
XLA; on the card it is kernel ``score_masks`` of ``csrc/masks.cu``, every
layer of a detection in one launch. A pixel of layer i is a candidate when

* its 2-D test passes: score >= thr and no 8-neighbour greater, on rows
  and columns [2, n-3] (``maxima2d_mask``), or K3's mask says so;
* above (layer i+1 exists, map (A, B, D) = ``above_map``): ``center * D^2``
  is at least each of the 9 probes at (x+dx, y+dy), a probe reading the
  D^2-scaled bilinear sum of layer i+1 at ((A*x'+B)/D, (A*y'+B)/D), and 0
  outside layer i or where the reference's bilinear is undefined;
* below (layer i-1 exists, ``below_map``): the same sum at (x, y) itself.

The sums are exact in int64 (the JAX package splits them into int32 words,
bit-equal). ``score_masks`` is what the detector calls: one kernel launch
for CUDA tensors (or it raises), the plain version for CPU tensors.
``score_masks_plain`` is the dense torch chain over every pixel;
``score_masks_twin`` is the kernel's per-pixel arithmetic in torch (the 2-D
test as a 3x3 maximum, the axis terms by truncating division, the probes
at the survivors only: the 9 above from the survivor's 4 x 4 patch of the
layer above, its rows' sums at the three probe columns, then each probe's
sum down its pair of rows), held against the JAX package on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.kernels.nms import max3x3_zero_fill, maxima2d_mask, warp_taps

MAX_LAYERS = 8  # the layer table of csrc/masks.cu
BORDER = 2
# csrc/masks.cu's tile and its shared memory: a CTA of THREADS takes a
# tile of TILE_H x TILE_W pixels and stages its halo rows (SCORE_BYTES)
# and on the fused path K3's mask rows (MASK_BYTES).
THREADS = 256
TILE_W, TILE_H = 128, 32
ROW_WORDS, MASK_ROW_BYTES = 140, 160
SCORE_BYTES = (TILE_H + 2) * ROW_WORDS * 4
MASK_BYTES = TILE_H * MASK_ROW_BYTES


def staged_bytes(fused: bool) -> int:
    """Kernel ``score_masks``' dynamic shared memory a CTA."""
    return SCORE_BYTES + (MASK_BYTES if fused else 0)


def warp_scores(
    src: torch.Tensor, affine: tuple[int, int, int], dst_shape: tuple[int, int]
) -> torch.Tensor:
    """D^2-scaled bilinear sample of a neighbour layer's scores, int64.

    W = D^2 * Score(u, v) with u = (A*x+B)/D, v = (A*y+B)/D, exactly; 0
    where the reference's bilinear returns 0 (``warp_taps``).
    """
    d = affine[2]
    (p00, p01, p10, p11), fu, fv, valid = warp_taps(src.to(torch.int64), affine, dst_shape)
    fu_t = torch.as_tensor(fu, device=src.device)[None, :]
    fv_t = torch.as_tensor(fv, device=src.device)[:, None]
    out = (d - fv_t) * ((d - fu_t) * p00 + fu_t * p01) + fv_t * (
        (d - fu_t) * p10 + fu_t * p11
    )
    return torch.where(valid, out, torch.zeros((), dtype=torch.int64, device=src.device))


def score_masks_plain(scores: list[torch.Tensor], thr: int, maps: list,
                      base_masks: "list[torch.Tensor] | None" = None) -> list[torch.Tensor]:
    """Plain version: the dense torch chain over every pixel of every layer.

    ``scores``: int32 (B, h, w) per layer; ``maps[i]``: layer i's
    (above_map, below_map), each (A, B, D); ``base_masks``: K3's 2-D maxima
    per layer, ANDed in place, or None for ``maxima2d_mask`` at ``thr``."""
    n_layers = len(scores)
    masks = []
    for i in range(n_layers):
        sc = scores[i]
        h, w = sc.shape[-2:]
        mask = base_masks[i] if base_masks is not None else maxima2d_mask(sc, thr)
        center = sc.to(torch.int64)
        if i + 1 < n_layers:
            # Above: the truncated one_over_scale_above == 1
            # (scale-space-layer-inl.h:225), so the reference probes the 9
            # points (x+-1, y+-1) of the warped map; out-of-image probes
            # read 0.
            a, b, d = maps[i][0]
            warped = warp_scores(scores[i + 1], (a, b, d), (h, w))
            mask &= center * (d * d) >= max3x3_zero_fill(warped)
        if i > 0:
            # Below: one_over_scale_below truncates to 0 -> one probe.
            a, b, d = maps[i][1]
            mask &= center * (d * d) >= warp_scores(scores[i - 1], (a, b, d), (h, w))
        masks.append(mask)
    return masks


def _axis(u: torch.Tensor, limit: int, a: int, b: int, d: int):
    """The kernel's axis terms at int64 coordinates ``u``: the index
    truncated toward zero, the signed fraction numerator, and whether the
    bilinear is defined (0 <= index and index + 1 < limit)."""
    val = a * u + b
    i0 = torch.div(val, d, rounding_mode="trunc")
    return i0, val - i0 * d, (i0 >= 0) & (i0 + 1 < limit)


def _probe(src: torch.Tensor, f: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
           inside: torch.Tensor, affine: tuple[int, int, int]) -> torch.Tensor:
    """The D^2-scaled bilinear sum of ``src`` (B, rows, cols) at the
    destination pixels (f, y, x), int64; 0 where ``inside`` is False or
    the sum is undefined. Only defined taps are read."""
    a, b, d = affine
    rows, cols = src.shape[-2:]
    v0, fv, okv = _axis(y, rows, a, b, d)
    u0, fu, oku = _axis(x, cols, a, b, d)
    ok = inside & okv & oku
    flat = src.reshape(-1).to(torch.int64)
    at = (f * rows + v0) * cols + u0
    p00, p01, p10, p11 = (flat[torch.where(ok, at + off, 0)] if flat.numel() else
                          torch.zeros_like(at) for off in (0, 1, cols, cols + 1))
    s = (d - fv) * ((d - fu) * p00 + fu * p01) + fv * ((d - fu) * p10 + fu * p11)
    return torch.where(ok, s, torch.zeros_like(s))


def _maxima2d_twin(sc: torch.Tensor, thr: int) -> torch.Tensor:
    """The kernel's 2-D test: on rows and columns [2, n-3], score >= thr
    and the 3x3 maximum, centre included, at most the score, taken as a
    horizontal then a vertical maximum of 3. No pixel on [2, n-3] reads a
    cell outside the map (the kernel's staged chunks hold other bytes
    there; the twin pads with 0)."""
    h, w = sc.shape[-2:]
    p = F.pad(sc, (1, 1, 1, 1), value=0)
    rows = torch.maximum(torch.maximum(p[..., :, :w], p[..., :, 1 : w + 1]), p[..., :, 2:])
    top = torch.maximum(torch.maximum(rows[..., :h, :], rows[..., 1 : h + 1, :]), rows[..., 2:, :])
    ok = (sc >= thr) & (top <= sc)
    ys = torch.arange(h, device=sc.device)[:, None]
    xs = torch.arange(w, device=sc.device)[None, :]
    inb = (ys >= BORDER) & (ys <= h - 1 - BORDER) & (xs >= BORDER) & (xs <= w - 1 - BORDER)
    return ok & inb


def _pick(o: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel's ``pick``: a where o is 0, b where 1, else c."""
    return torch.where(o == 0, a, torch.where(o == 1, b, c))


def _top_above(src: torch.Tensor, f, y, x, h: int, w: int, affine) -> torch.Tensor:
    """The maximum of the 9 probes above survivors (f, y, x) of an h x w
    layer, as the kernel sums them: the survivor's 4 x 4 patch of ``src``
    (indices clamped to it), the patch rows' sums at the three probe
    columns, then each probe's sum down its pair of rows; 0 for a probe
    outside the layer or undefined."""
    a, b, d = affine
    rows, cols = src.shape[-2:]
    vs = [_axis(y + k - 1, rows, a, b, d) for k in range(3)]
    us = [_axis(x + k - 1, cols, a, b, d) for k in range(3)]
    pr, pc = vs[0][0], us[0][0]
    flat = src.to(torch.int64).reshape(-1)
    patch = [[flat[(f * rows + (pr + i).clamp(0, rows - 1)) * cols + (pc + j).clamp(0, cols - 1)]
              if flat.numel() else torch.zeros_like(f) for j in range(4)] for i in range(4)]
    sums = []
    for i0, fu, _ in us:
        o = i0 - pc
        sums.append([(d - fu) * _pick(o, *p[:3]) + fu * _pick(o, *p[1:]) for p in patch])
    top = None
    for ky, (v0, fv, okv) in enumerate(vs):
        o, yy = v0 - pr, y + ky - 1
        for kx, (_, _, oku) in enumerate(us):
            xx = x + kx - 1
            col = sums[kx]
            s = (d - fv) * _pick(o, *col[:3]) + fv * _pick(o, *col[1:])
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) & okv & oku
            p = torch.where(ok, s, torch.zeros_like(s))
            top = p if top is None else torch.maximum(top, p)
    return top


def score_masks_twin(scores: list[torch.Tensor], thr: int, maps: list,
                     base_masks: "list[torch.Tensor] | None" = None) -> list[torch.Tensor]:
    """The kernel's per-pixel arithmetic in torch: the 2-D test (or K3's
    mask), then the 3-D probes at the survivors only, those above from the
    survivor's patch; any device."""
    n_layers = len(scores)
    masks = []
    for i, sc in enumerate(scores):
        h, w = sc.shape[-2:]
        mask2d = base_masks[i] if base_masks is not None else _maxima2d_twin(sc, thr)
        f, y, x = mask2d.nonzero(as_tuple=True)
        center = sc[f, y, x].to(torch.int64)
        keep = torch.ones_like(f, dtype=torch.bool)
        if i + 1 < n_layers:
            d = maps[i][0][2]
            keep &= center * (d * d) >= _top_above(scores[i + 1], f, y, x, h, w, maps[i][0])
        if i > 0:
            a, b, d = maps[i][1]
            below = _probe(scores[i - 1], f, y, x, torch.ones_like(keep), (a, b, d))
            keep &= center * (d * d) >= below
        mask = torch.zeros(sc.shape, dtype=torch.bool, device=sc.device)
        mask[f[keep], y[keep], x[keep]] = True
        masks.append(mask)
    return masks


def _check_thr(thr: int) -> int:
    thr = int(thr)
    i32 = torch.iinfo(torch.int32)
    if not i32.min <= thr <= i32.max:
        raise ValueError(f"threshold {thr} does not fit int32")
    return thr


def launch_plan(scores: list[torch.Tensor], thr: int, maps: list,
                base_masks: "list[torch.Tensor] | None" = None):
    """The launches of kernel ``score_masks`` on ``score_masks_cuda``'s
    arguments, checked: (outputs, [(layer table, layer count), ...]), the
    tables ctypes int64 arrays of 17 fields a layer, up to 8 layers each.
    A single layer with a K3 mask has no check left: its mask is the
    output and there is no launch."""
    thr = _check_thr(thr)
    n_layers = len(scores)
    if len(maps) != n_layers or (base_masks is not None and len(base_masks) != n_layers):
        raise ValueError(f"score_masks_cuda: {n_layers} layers, {len(maps)} maps")
    dev = scores[0].device
    if dev.type != "cuda":
        raise ValueError(f"score_masks_cuda needs CUDA tensors, got {dev}")
    frames = scores[0].shape[0]
    for i, sc in enumerate(scores):
        if (sc.device != dev or sc.dtype != torch.int32 or sc.dim() != 3
                or sc.shape[0] != frames or not sc.is_contiguous()):
            raise ValueError(f"layer {i}: expected contiguous int32 ({frames}, h, w) on {dev}, "
                             f"got {sc.dtype} {tuple(sc.shape)} on {sc.device}")
        if base_masks is not None:
            m = base_masks[i]
            if (m.device != dev or m.dtype != torch.bool or m.shape != sc.shape
                    or not m.is_contiguous()):
                raise ValueError(f"base mask {i}: expected contiguous bool "
                                 f"{tuple(sc.shape)} on {dev}")
    if n_layers == 1 and base_masks is not None:
        return [base_masks[0]], []
    outs = [torch.empty(sc.shape, dtype=torch.bool, device=dev) for sc in scores]
    rows = []
    for i, sc in enumerate(scores):
        if sc.numel() == 0:
            continue
        fields = [sc.data_ptr(), 0 if base_masks is None else base_masks[i].data_ptr(),
                  outs[i].data_ptr(), sc.shape[1], sc.shape[2]]
        for j, affine in ((i + 1, maps[i][0]), (i - 1, maps[i][1])):
            if 0 <= j < n_layers:
                fields += [scores[j].data_ptr(), scores[j].shape[1], scores[j].shape[2], *affine]
            else:
                fields += [0] * 6  # D = 0: no such layer
        rows.append(fields)
    chunks = [rows[k : k + MAX_LAYERS] for k in range(0, len(rows), MAX_LAYERS)]
    return outs, [((ctypes.c_int64 * (len(c) * len(c[0])))(*(v for r in c for v in r)), len(c))
                  for c in chunks]


def score_masks_cuda(scores: list[torch.Tensor], thr: int, maps: list,
                     base_masks: "list[torch.Tensor] | None" = None) -> list[torch.Tensor]:
    """Kernel ``score_masks``: every layer of a pyramid in one launch (up
    to 8 layers a launch; a layer's neighbours may lie in another launch).

    ``scores``: contiguous int32 (B, h, w) CUDA tensors on one card, one B;
    ``base_masks``: K3's bool masks of the same shapes, or None for the
    kernel's own 2-D test at ``thr``. A single layer with a K3 mask has no
    check left: its mask is returned and nothing is launched."""
    outs, launches = launch_plan(scores, thr, maps, base_masks)
    for table, n in launches:
        _kernels.launch("score_masks", "score_masks", scores[0].device, table, n,
                        scores[0].shape[0], int(thr))
    return outs


def score_masks(scores: list[torch.Tensor], thr: int, maps: list,
                base_masks: "list[torch.Tensor] | None" = None) -> list[torch.Tensor]:
    """The candidate masks of every layer: kernel ``score_masks`` (one
    launch) for CUDA tensors, ``score_masks_plain`` for CPU tensors."""
    if all(sc.device.type == "cpu" for sc in scores):
        return score_masks_plain(scores, thr, maps, base_masks)
    return score_masks_cuda([sc.contiguous() for sc in scores], thr, maps,
                            None if base_masks is None else [m.contiguous() for m in base_masks])
