"""The sharded layer across processes: a distributed BA and pose-graph
worker, and the multi-device dry run (the counterparts of
``tools/multihost_worker.py`` and ``__graft_entry__.py dryrun``).

    python -m ethzasl_brisk_tpu_torch.parallel worker RANK WORLD STORE_DIR \\
        [--out FILE] [--device cuda|cpu]
    python -m ethzasl_brisk_tpu_torch.parallel dryrun N [--store DIR] [--device cuda|cpu]

``worker`` is one rank of ``tools/multihost_worker.py``'s run: the
deterministic landmark-sharded BA (8 iterations) and edge-sharded pose
graph (12 iterations) over a (1, WORLD) mesh; start WORLD of them with
the same STORE_DIR. Rank 0 writes "first BA cost, last BA cost, last pose
graph cost, largest translation error" to ``--out`` (default
``STORE_DIR/result.txt``).

``dryrun`` starts N ranks (one per card, or N CPU processes with ``--device
cpu``) and runs ``__graft_entry__.py``'s dry run with its caps on VGA
smoothed-noise frames over an (N/2, 2) mesh (N even, else (N, 1)): the
data-parallel frame step, bitwise against one device's step with its
capacity certificates asserted, and the AST step likewise on 240 x 320
crops; the sharded knn, bitwise against the dense knn; the distributed BA;
and the sharded pose graph against the replicated one. It prints ``dryrun_multichip
ok``.

Ranks meet through a ``FileStore`` in the directory the caller names
(``dryrun`` makes a temporary one without ``--store``), never a fixed TCP
port. The card takes NCCL, the CPU gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ethzasl_brisk_tpu_torch.ba.pose_graph import PoseGraph, optimize_pose_graph
from ethzasl_brisk_tpu_torch.ba.se3 import so3_exp
from ethzasl_brisk_tpu_torch.ba.window import BaProblem
from ethzasl_brisk_tpu_torch.parallel.dist_ba import partition_problem, solve_window_ba_sharded
from ethzasl_brisk_tpu_torch.parallel.dist_pg import optimize_pose_graph_sharded, partition_edges
from ethzasl_brisk_tpu_torch.parallel.frames import (
    FramePipeline,
    init_process_group,
    make_mesh,
    mesh_device,
    sharded_knn_match,
)

JOIN_TIMEOUT_S = 600.0
# __graft_entry__.py's dry-run feature (:82-100): caps sized for the
# smoothed-noise frames; the JAX-only selectors are checked no-ops.
DRYRUN_FEATURE = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(12288, 4096, 4096, 2048), max_keypoints=1024,
    sampler="patch_pallas", patch_h=128, patch_w=128, topk_impl="block",
    topk_block_size=2048, topk_block_r=256, refine_capacity=(768, 384, 256, 128),
    describe_capacity=768,
)


def circle_graph(n: int, radius: float, rng: np.random.Generator, rot_noise: float,
                 t_noise: float, dtype=np.float32):
    """multihost_worker's (and the JAX tests') pose graph: n poses on a
    circle, odometry edges and one loop closure, noisy initial poses (node
    0 exact). Returns (graph on the CPU, ground-truth translations)."""
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r_gt = np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                               [0, 0, 1]]) for a in angles])
    c_gt = np.stack([radius * np.cos(angles), radius * np.sin(angles), np.zeros(n)], 1)
    t_gt = -np.einsum("nij,nj->ni", r_gt, c_gt)
    ei = np.append(np.arange(n - 1), n - 1)
    ej = np.append(np.arange(1, n), 0)
    rel_r = np.einsum("nij,nkj->nik", r_gt[ei], r_gt[ej])
    rel_t = t_gt[ei] - np.einsum("nij,nj->ni", rel_r, t_gt[ej])
    w_noise = rng.normal(0, rot_noise, (n, 3))
    w_noise[0] = 0
    r0 = so3_exp(torch.from_numpy(w_noise.astype(dtype))).numpy() @ r_gt
    t0 = t_gt + rng.normal(0, t_noise, (n, 3)) * (np.arange(n) > 0)[:, None]
    graph = PoseGraph.from_numpy(dict(
        r=r0.astype(dtype), t=t0.astype(dtype), edge_i=ei, edge_j=ej,
        rel_r=rel_r.astype(dtype), rel_t=rel_t.astype(dtype),
        weight=np.ones(len(ei), dtype)), device="cpu")
    return graph, t_gt


def worker_problem(rng: np.random.Generator) -> BaProblem:
    """multihost_worker's deterministic BA problem (5 poses, 64
    landmarks, every landmark seen from every pose), float32 on the CPU."""
    k_pose, n_lm = 5, 64
    pts = rng.uniform([-2, -2, 4], [2, 2, 9], (n_lm, 3))
    t_cam = np.stack([np.linspace(0, 0.8, k_pose), np.zeros(k_pose), np.zeros(k_pose)], 1)
    kf = np.repeat(np.arange(k_pose), n_lm)
    lm = np.tile(np.arange(n_lm), k_pose)
    x_c = pts[lm] - t_cam[kf]
    uv = np.stack([300.0 * x_c[:, 0] / x_c[:, 2] + 160, 300.0 * x_c[:, 1] / x_c[:, 2] + 120], 1)
    f32 = np.float32
    return BaProblem.from_numpy(dict(
        r=np.tile(np.eye(3, dtype=f32), (k_pose, 1, 1)),
        t=(-t_cam + rng.normal(0, 0.01, t_cam.shape)
           * (np.arange(k_pose) > 0)[:, None]).astype(f32),
        points=(pts + rng.normal(0, 0.05, pts.shape)).astype(f32),
        kf_idx=kf, lm_idx=lm, uv=uv.astype(f32), valid=np.ones(len(kf), bool),
        fu=f32(300.0), fv=f32(300.0), cu=f32(160.0), cv=f32(120.0)), device="cpu")


def run_worker(mesh) -> tuple[np.ndarray, np.ndarray, float]:
    """multihost_worker's run on an initialised (1, M) mesh: (BA costs,
    pose-graph costs, largest pose-graph translation error)."""
    n_model = mesh.mesh.shape[1]
    rng = np.random.default_rng(11)
    sharded = partition_problem(worker_problem(rng), n_model)
    _, costs = solve_window_ba_sharded(mesh, sharded, iterations=8, damping=1e-3)
    graph, t_gt = circle_graph(12, 5.0, rng, 0.03, 0.2)
    out, pg_costs = optimize_pose_graph_sharded(mesh, partition_edges(graph, n_model),
                                                iterations=12, damping=1e-5)
    t_err = float(np.abs(out.t.cpu().numpy() - t_gt).max())
    return costs.cpu().numpy(), pg_costs.cpu().numpy(), t_err


def worker(rank: int, world: int, store_dir, out=None, device: str = "cuda") -> None:
    """One rank of the worker run (module docstring)."""
    dev = init_process_group(rank, world, store_dir, device)
    try:
        mesh = make_mesh(1, world, dev)
        costs, pg_costs, t_err = run_worker(mesh)
        if rank == 0:
            out = pathlib.Path(out or pathlib.Path(store_dir) / "result.txt")
            out.write_text(f"{costs[0]:.6e} {costs[-1]:.6e} {pg_costs[-1]:.6e} {t_err:.6e}\n")
        print(f"rank {rank}: cost {costs[0]:.3e} -> {costs[-1]:.3e}; pg {pg_costs[0]:.3e} -> "
              f"{pg_costs[-1]:.3e} terr {t_err:.3e}", flush=True)
    finally:
        dist.destroy_process_group()


def _assert_same_step(got, one, what: str) -> None:
    """A step over the mesh against one device's: every output bitwise (the
    angle's ``atan2f`` takes each lane on its own, on either device)."""
    names = [f.name for f in dataclasses.fields(got[0])] + ["desc", "match idx", "match dist"]
    for name, a, b in zip(names, (*got[0].fields(), *got[1:4]), (*one[0].fields(), *one[1:4])):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from one device")


def run_dryrun(mesh) -> dict:
    """``__graft_entry__.py``'s dry run on an initialised (data, model)
    mesh; raises on any failed check. Returns a few counts."""
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.match.matcher import knn_match
    from ethzasl_brisk_tpu_torch.parallel.frames import AstFramePipeline
    from ethzasl_brisk_tpu_torch.pipeline import BriskFeature, BriskFeatureDetector

    dev = mesh_device(mesh)
    n_data, n_model = mesh.mesh.shape
    feature = BriskFeature(**DRYRUN_FEATURE, device=dev)
    frames = torch.from_numpy(bench_frames(2 * n_data, seed=1))
    kps, desc, midx, mdist, diag = FramePipeline(feature, dev, mesh).step(
        frames, with_diagnostics=True)
    # The capacity certificates, so the equality covers the regime without
    # truncation.
    if not bool(diag["detect"].ok.all()):
        raise AssertionError(f"dry-run caps truncate: {diag['detect'].cand_counts.tolist()}, "
                             f"{diag['detect'].accepted_counts.tolist()}")
    if int(diag["describable"]) > DRYRUN_FEATURE["describe_capacity"] * frames.shape[0]:
        raise AssertionError(f"describe budget truncates: {int(diag['describable'])}")
    one = FramePipeline(feature, dev).step(frames)
    _assert_same_step((kps, desc, midx, mdist), one, "multi-device step")
    n_min = int(kps.valid.sum(dim=1).min())
    if n_min <= 50:
        raise AssertionError(f"too few keypoints on a frame: {n_min}")

    # The AST step over the same mesh on 240 x 320 crops, against one device.
    ast_det = BriskFeatureDetector(threshold=70, octaves=2, max_candidates_per_layer=1024,
                                   detect_impl="dense", device=dev)
    ast_frames = frames[:, :240, :320]
    ast = AstFramePipeline(ast_det, dev, describe_capacity=256, mesh=mesh).step(ast_frames)
    ast_one = AstFramePipeline(ast_det, dev, describe_capacity=256).step(ast_frames)
    _assert_same_step(ast, ast_one, "multi-device AST step")
    n_ast = int(ast[0].valid.sum())
    if n_ast <= 50:
        raise AssertionError(f"too few AST keypoints: {n_ast}")

    # Sharded matching over the model axis, against the dense knn.
    t_cap = desc.shape[1]
    train = desc[0]
    pad = (-t_cap) % n_model
    if pad:
        train = torch.cat([train, train.new_zeros((pad, train.shape[1]))])
    tv = torch.arange(train.shape[0], device=dev) < t_cap
    idx, dist_k = sharded_knn_match(mesh, desc[1], train, tv, k=2)
    ref_idx, ref_dist = knn_match(desc[1], train, torch.ones_like(kps.valid[1]), tv, k=2)
    if not (torch.equal(idx, ref_idx) and torch.equal(dist_k, ref_dist)):
        raise AssertionError("sharded knn differs from the dense knn")

    # Distributed BA: landmarks sharded over the model axis.
    rng = np.random.default_rng(1)
    k_pose, n_lm, n_obs = 4, 8 * n_model, 24 * n_model
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], (n_lm, 3))
    kf = rng.integers(0, k_pose, n_obs)
    lm = rng.integers(0, n_lm, n_obs)
    x_c = pts[lm]
    uv = np.stack([200.0 * x_c[:, 0] / x_c[:, 2] + 64, 200.0 * x_c[:, 1] / x_c[:, 2] + 48], 1)
    f32 = np.float32
    prob = BaProblem.from_numpy(dict(
        r=np.tile(np.eye(3, dtype=f32), (k_pose, 1, 1)), t=np.zeros((k_pose, 3), f32),
        points=pts.astype(f32), kf_idx=kf, lm_idx=lm, uv=uv.astype(f32),
        valid=np.ones(n_obs, bool), fu=f32(200.0), fv=f32(200.0), cu=f32(64.0),
        cv=f32(48.0)), device=dev)
    _, ba_costs = solve_window_ba_sharded(mesh, partition_problem(prob, n_model), iterations=2)
    if not bool(torch.isfinite(ba_costs).all()):
        raise AssertionError(f"distributed BA costs {ba_costs.tolist()}")

    # Edge-partitioned pose graph against the replicated solve.
    graph, _ = circle_graph(10, 4.0, rng, 0.0, 0.1)
    graph = dataclasses.replace(graph, r=graph.r.to(dev), t=graph.t.to(dev),
                                edge_i=graph.edge_i.to(dev), edge_j=graph.edge_j.to(dev),
                                rel_r=graph.rel_r.to(dev), rel_t=graph.rel_t.to(dev),
                                weight=graph.weight.to(dev))
    out_rep, _ = optimize_pose_graph(graph, iterations=8, damping=1e-5)
    out_sh, costs_sh = optimize_pose_graph_sharded(mesh, partition_edges(graph, n_model),
                                                   iterations=8, damping=1e-5)
    if not float(costs_sh[-1]) < 1e-6:
        raise AssertionError(f"sharded pose graph did not converge: {costs_sh.tolist()}")
    gap = max(float((out_sh.t - out_rep.t).abs().max()), float((out_sh.r - out_rep.r).abs().max()))
    if gap > 1e-4:
        raise AssertionError(f"sharded pose graph {gap} from the replicated one")
    return dict(frames=int(frames.shape[0]), keypoints_min=n_min,
                describable=int(diag["describable"]), ast_keypoints=n_ast, pose_graph_gap=gap)


def _dryrun_rank(rank: int, world: int, store_dir: str, device: str) -> None:
    dev = init_process_group(rank, world, store_dir, device)
    try:
        n_model = 2 if world % 2 == 0 and world > 1 else 1
        info = run_dryrun(make_mesh(world // n_model, n_model, dev))
        if rank == 0:
            print(f"dryrun {world} rank(s) on {dev.type}: {info}", flush=True)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple, timeout: float = JOIN_TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; raise if one
    fails or outlives ``timeout`` (then every one is killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(rank, *args)) for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"ranks still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def dryrun(n: int, store_dir, device: str = "cuda") -> None:
    """The dry run over ``n`` ranks (module docstring)."""
    if device != "cpu" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards, the machine has "
                         f"{torch.cuda.device_count()}")
    if n == 1:
        _dryrun_rank(0, 1, str(store_dir), device)
    else:
        spawn(_dryrun_rank, n, (n, str(store_dir), device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.parallel")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker")
    w.add_argument("rank", type=int)
    w.add_argument("world", type=int)
    w.add_argument("store")
    w.add_argument("--out", default=None)
    w.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    d = sub.add_parser("dryrun")
    d.add_argument("n", type=int, nargs="?", default=1)
    d.add_argument("--store", default=None, help="rendezvous directory (default: a new "
                                                 "temporary one)")
    d.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        worker(args.rank, args.world, args.store, args.out, args.device)
        return 0
    if args.store is not None:
        dryrun(args.n, args.store, args.device)
    else:
        with tempfile.TemporaryDirectory() as store:
            dryrun(args.n, store, args.device)
    print("dryrun_multichip ok")
    return 0

