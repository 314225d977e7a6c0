"""Batched detect + describe + match step, on one device or over a mesh
(port of ``parallel/frames.py``).

``step`` detects and describes every frame of a batch, then matches each
frame against the one before it, the building block of the VO front-end
and of the throughput benchmark. ``AstFramePipeline`` is the same step
around the classic AGAST/OAST detector (``BriskFeatureDetector``),
bench.py's ``BENCH_PIPELINE=ast``.

The JAX package's (data, model) mesh becomes a
``torch.distributed.device_mesh.DeviceMesh`` over one process per device
(``make_mesh``, in a process group that ``init_process_group`` or the
caller has initialised: NCCL on the card, gloo only on the CPU):

* ``data`` (``FramePipeline`` and ``AstFramePipeline``): each rank detects
  and describes its block of the batch; the ranks then ``all_gather``
  keypoints and descriptors, and every rank matches the gathered batch.
  The describe budget stays the whole batch's (``describe_capacity * B``,
  truncated in the batch's flat order, as the JAX step's one compaction
  does): the ranks exchange their describable counts and each describes
  its share of the global prefix.
* ``model``: the train descriptors of ``sharded_knn_match`` are split over
  the ranks; each computes its distance tile and its k best, and only the
  (Q, k) candidates are gathered (communication O(Q k), not O(Q T)).
"""
from __future__ import annotations

import dataclasses
import pathlib

import torch
import torch.distributed as dist

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.core.selectors import check_extractor_selectors
from ethzasl_brisk_tpu_torch.describe.extractor import (
    check_u8_batch,
    describable_count,
    describe_budget,
    extract_descriptors_compact,
)
from ethzasl_brisk_tpu_torch.detect.scale_space import Mark, _no_mark
from ethzasl_brisk_tpu_torch.match.matcher import (
    _sentinel_where,
    _smallest,
    hamming_distance_matrix,
    match_adjacent,
)
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature, BriskFeatureDetector


def init_process_group(rank: int, world_size: int, store_dir,
                       device: str | torch.device = "cuda") -> torch.device:
    """Join a process group of ``world_size`` ranks through a ``FileStore``
    in ``store_dir`` (which every rank names; no TCP port). The card
    (``cuda:rank`` modulo the cards there are) takes NCCL, which must
    initialise or this raises; ``device="cpu"`` takes gloo. Returns the
    rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a card was asked for, but this torch has no NCCL")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    path = pathlib.Path(store_dir)
    path.mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(str(path / "store"), world_size)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, **kw)
    return dev


def make_mesh(n_data: int, n_model: int = 1, device: str | torch.device = "cuda"):
    """A (data, model) device mesh over the initialised process group: data
    scales frames, model scales match/BA. Its device type follows
    ``device``: NCCL's group for the card, gloo's for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_process_group)")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend, the group has "
                           f"{dist.get_backend()}")
    if dist.get_world_size() != n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_axis(mesh, name: str):
    """(process group, size, this rank's coordinate) of the mesh axis ``name``."""
    group = mesh.get_group(name)
    return group, dist.get_world_size(group), mesh.get_local_rank(name)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (bool
    tensors travel as uint8)."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def sharded_knn_match(mesh, query: torch.Tensor, train: torch.Tensor,
                      train_valid: torch.Tensor, k: int = 2, n_bits: int = 384):
    """knn over a train set split over the mesh's ``model`` axis.

    ``query`` (Q, W) and the whole ``train`` (T, W) and ``train_valid``
    (T,) are given on every rank; rank m takes train block m of T / M, as
    ``P("model")`` gives it. Each rank computes its distance tile and its k
    best, the ranks exchange only the (Q, k) candidates, and the global k
    best are taken from them. Exact: Hamming distances are integers, and
    ties go to the lowest global index, as the reference's row scan
    (brute-force-matcher.cc:138-157). Returns (idx (Q, k) int32,
    dist (Q, k) int32), the same on every rank.
    """
    group, n_model, coord = mesh_axis(mesh, "model")
    t_total = train.shape[0]
    if t_total % n_model:
        raise ValueError(f"train rows {t_total} must divide over the model axis {n_model}")
    t_local = t_total // n_model
    dev = mesh_device(mesh)
    rows = slice(coord * t_local, (coord + 1) * t_local)
    d = hamming_distance_matrix(query.to(dev), train[rows].to(dev), n_bits)
    d = _sentinel_where(train_valid[rows].to(dev)[None, :], d, n_bits)
    dist_l, idx_l = _smallest(d, min(k, t_local))
    gidx = idx_l.to(torch.int64) + coord * t_local
    all_d = all_gather_cat(dist_l, group, dim=1)
    all_i = all_gather_cat(gidx, group, dim=1)
    # Global k best on (distance, index): the keys are distinct.
    order = torch.argsort(all_d.to(torch.int64) * t_total + all_i, dim=1)[:, :k]
    best_idx = torch.gather(all_i, 1, order).to(torch.int32)
    best_d = torch.gather(all_d, 1, order).to(torch.int32)
    return best_idx, best_d


def _sharded_detect_describe(mesh, device: torch.device, frames: torch.Tensor, detect, pattern,
                             describe_capacity: int, rotation_invariant: bool,
                             scale_invariant: bool, mark: Mark):
    """Detect and describe this rank's block of ``frames`` (its ``data``
    coordinate's) within the whole batch's describe budget, then gather the
    batch: (keypoints, diagnostics, descriptors, describable count), each
    the whole batch's. The describable counts travel first, so each rank
    describes the slots the whole batch's compaction would."""
    group, n_data, coord = mesh_axis(mesh, "data")
    b = frames.shape[0]
    if b % n_data:
        raise ValueError(f"batch {b} must divide over the data axis {n_data}")
    b_local = b // n_data
    local = frames[coord * b_local:(coord + 1) * b_local].to(device)
    check_u8_batch(local)
    kps, diag = detect(local, with_diagnostics=True, mark=mark)
    n_slots = b_local * kps.capacity
    cap = describe_budget(describe_capacity, b, kps.capacity)
    counts = all_gather_cat(
        describable_count(pattern, local, kps, scale_invariant=scale_invariant).reshape(1),
        group).tolist()
    # The batch's compaction takes its describables in flat order, then its
    # other slots. This block's share of that prefix is a prefix of its own
    # compaction: its other slots come in only once every describable has.
    n_d, before_d, total_d = counts[coord], sum(counts[:coord]), sum(counts)
    before_o = coord * n_slots - before_d
    local_cap = (min(max(cap - before_d, 0), n_d)
                 + min(max(cap - total_d - before_o, 0), n_slots - n_d))
    kps, desc = extract_descriptors_compact(
        pattern, local, kps, capacity=local_cap, rotation_invariant=rotation_invariant,
        scale_invariant=scale_invariant,
    )
    kps = KeyPoints(*(all_gather_cat(a, group) for a in kps.fields()))
    desc = all_gather_cat(desc, group)
    # Every certificate field but the static caps has a leading batch axis.
    diag = diag._replace(**{f: all_gather_cat(getattr(diag, f), group)
                            for f in diag._fields if not f.endswith("_caps")})
    return kps, diag, desc, torch.tensor(total_d, dtype=torch.int32, device=device)


def _check_mesh(mesh, device: torch.device) -> None:
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a pipeline on {device}")


def _same_device(module, device) -> torch.device:
    dev = resolve_device(device)
    if module.device != dev:
        raise ValueError(
            f"the {type(module).__name__} runs on {module.device}, the pipeline on {dev}: "
            "build both with the same device"
        )
    return dev


@dataclasses.dataclass
class FramePipeline:
    """The step on ``device``: the card unless ``device="cpu"``. The
    feature must live there too (build it with the same ``device``).

    With a ``mesh`` (``make_mesh``, of that device type) the step is
    data-parallel over its ``data`` axis: every rank passes the whole
    batch, detects and describes its block, and returns the whole batch's
    outputs, the same on every rank and bitwise those of one device.
    """

    feature: BriskFeature
    device: str | torch.device = "cuda"
    mesh: object = None

    def __post_init__(self):
        self.device = _same_device(self.feature, self.device)
        _check_mesh(self.mesh, self.device)

    def step(self, frames: torch.Tensor, with_diagnostics: bool = False,
             mark: Mark = _no_mark):
        """frames: (B, H, W) uint8 (uint16 raises: the batched describe is
        uint8 only), moved to the pipeline's device; over a mesh, B must
        divide by its ``data`` size.

        Returns, on that device, (keypoints (B, K), descriptors (B, K, W)
        int32 words, match_idx (B-1, K) int32, match_dist (B-1, K) int32),
        and with ``with_diagnostics`` a dict holding the DetectDiagnostics
        (``detect``) and the batch's describable count (``describable``).
        ``mark(stage)`` is called after each stage. As the JAX step
        (``_pipeline_step``), the match counts the first 384 bits with
        sentinel 385 whatever W, and the describe rounds as v2.
        """
        if self.mesh is not None:
            feat = self.feature
            kps, diag, desc, n_desc = _sharded_detect_describe(
                self.mesh, self.device, frames, feat.detect, feat.pattern,
                feat.describe_capacity, feat.extractor.rotation_invariant,
                feat.extractor.scale_invariant, mark)
        else:
            frames = frames.to(self.device)
            kps, diag = self.feature.detect(frames, with_diagnostics=True, mark=mark)
            kps, desc, n_desc = self.feature.describe(frames, kps, with_diagnostics=True)
        mark("describe")
        midx, mdist = match_adjacent(desc, kps.valid)
        mark("match")
        if with_diagnostics:
            return kps, desc, midx, mdist, {"detect": diag, "describable": n_desc}
        return kps, desc, midx, mdist


@dataclasses.dataclass
class AstFramePipeline:
    """The classic-BRISK (AGAST/OAST) batched detect + describe + match
    step on ``device``, the card unless ``device="cpu"``; the detector must
    live there too.

    ``describe_capacity`` is the budget of describable keypoints per frame
    (0 describes every slot): the batch's first ``describe_capacity * B``
    describable keypoints in flat order are described, the rest dropped
    (``extract_descriptors_compact``). ``sampler``, ``patch_h`` and
    ``patch_w`` are the JAX package's sampler selectors, checked no-ops:
    kernel K2 serves every describe. A ``mesh`` makes the step
    data-parallel over its ``data`` axis, as ``FramePipeline``'s.
    """

    detector: BriskFeatureDetector
    device: str | torch.device = "cuda"
    sampler: str = "patch_pallas"
    patch_h: int = 256
    patch_w: int = 256
    describe_capacity: int = 640
    mesh: object = None

    def __post_init__(self):
        check_extractor_selectors(self.sampler, self.patch_h, self.patch_w)
        self.device = _same_device(self.detector, self.device)
        _check_mesh(self.mesh, self.device)

    def step(self, frames: torch.Tensor, with_diagnostics: bool = False,
             mark: Mark = _no_mark):
        """frames: (B, H, W) uint8, moved to the pipeline's device.

        Returns (keypoints (B, K), descriptors (B, K, W) int32 words,
        match_idx (B-1, K) int32, match_dist (B-1, K) int32), and with
        ``with_diagnostics`` a dict holding the AstDiagnostics (``detect``)
        and the batch's describable count (``describable``). ``mark(stage)``
        is called after each stage: pyramid, layers, candidates, pass1, aux,
        pass2, describe, match.

        As the JAX step (``_ast_pipeline_step``): the match runs over all
        ``W * 32`` bits of the descriptors (512 for v1) with sentinel
        ``W * 32 + 1``, and the describe does not pass ``v1_rounding`` on,
        so a v1 detector describes with the v1 pattern and v2 rounding (the
        facade's ``detect_and_compute`` rounds as v1).
        """
        det = self.detector
        if self.mesh is not None:
            kps, diag, desc, n_desc = _sharded_detect_describe(
                self.mesh, self.device, frames, det.detect, det.pattern,
                self.describe_capacity, det.rotation_invariant, det.scale_invariant, mark)
        else:
            frames = frames.to(self.device)
            check_u8_batch(frames)
            kps, diag = det.detect(frames, with_diagnostics=True, mark=mark)
            cap = describe_budget(self.describe_capacity, frames.shape[0], kps.capacity)
            kps, desc, n_desc = extract_descriptors_compact(
                det.pattern, frames, kps, capacity=cap,
                rotation_invariant=det.rotation_invariant, scale_invariant=det.scale_invariant,
                with_diagnostics=True,
            )
        mark("describe")
        midx, mdist = match_adjacent(desc, kps.valid, n_bits=desc.shape[-1] * 32)
        mark("match")
        if with_diagnostics:
            return kps, desc, midx, mdist, {"detect": diag, "describable": n_desc}
        return kps, desc, midx, mdist
